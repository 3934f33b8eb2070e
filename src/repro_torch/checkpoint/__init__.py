from repro_torch.checkpoint.checkpoint import (
    decode,
    encode,
    is_complete,
    latest_step,
    load_layout_descriptor,
    restore,
    save,
    save_layout_descriptor,
    saved_keys,
    schedule_digest,
    valid_steps,
)

__all__ = ["save", "restore", "saved_keys", "is_complete", "valid_steps",
           "latest_step", "schedule_digest", "save_layout_descriptor",
           "load_layout_descriptor", "encode", "decode"]
