"""Per-arch distribution policy of the port: which archs train on the
sharded flat engine.

Copy of ``FSDP_ARCHS`` / ``needs_fsdp`` from ``repro/sharding/specs.py``
(that module imports jax): archs whose parameters cannot replicate across
the data-parallel ranks run the sharded flat engine, params and optimizer
moments resident 1/N per rank (DESIGN.md §8).
"""
from __future__ import annotations

FSDP_ARCHS = frozenset(
    {"deepseek-v2-236b", "llama4-maverick-400b-a17b", "llama-3.2-vision-90b"}
)


def needs_fsdp(arch_name: str) -> bool:
    return arch_name.split("-smoke")[0] in FSDP_ARCHS
