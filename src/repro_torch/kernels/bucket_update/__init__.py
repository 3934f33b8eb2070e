from repro_torch.kernels.bucket_update.ops import (
    apply_bucket_updates,
    bucket_update,
    bucket_update_cuda,
    bucket_update_ref,
    init_flat_opt_state,
    pack_scalars,
)
from repro_torch.kernels.bucket_update.segments import (
    BucketSegments,
    build_segments,
)

__all__ = [
    "apply_bucket_updates", "bucket_update", "bucket_update_cuda",
    "bucket_update_ref", "init_flat_opt_state", "pack_scalars",
    "BucketSegments", "build_segments",
]
