from repro_torch.data.pipeline import make_batch

__all__ = ["make_batch"]
