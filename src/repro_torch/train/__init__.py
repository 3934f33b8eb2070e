from repro_torch.train.bucketing import (
    BucketLayout,
    assign_buckets,
    build_bucket_layout,
    flatten_buckets,
    leaf_bucket_times,
    unflatten_buckets,
)
from repro_torch.train.runtime import (
    DeftRuntime,
    init_ddp_state,
    make_ddp_step,
    phase_collectives,
)

__all__ = [
    "BucketLayout", "assign_buckets", "build_bucket_layout",
    "flatten_buckets", "leaf_bucket_times", "unflatten_buckets",
    "DeftRuntime", "init_ddp_state", "make_ddp_step", "phase_collectives",
]
