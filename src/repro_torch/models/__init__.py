from repro_torch.models.model import forward, init_params, loss_fn, stack_layout

__all__ = ["forward", "init_params", "loss_fn", "stack_layout"]
