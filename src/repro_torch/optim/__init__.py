from repro_torch.optim.optimizers import (
    OptimizerSpec,
    SegmentHParams,
    adamw,
    apply_updates,
    init_opt_state,
    leaf_hparams,
    sgd_momentum,
)

__all__ = [
    "OptimizerSpec", "SegmentHParams", "adamw", "apply_updates",
    "init_opt_state", "leaf_hparams", "sgd_momentum",
]
