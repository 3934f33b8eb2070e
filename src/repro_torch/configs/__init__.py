"""Architecture registry of the port: the dense decoders gemma2-2b,
qwen3-4b (its main path), starcoder2-7b and deepseek-7b, the Griffin
hybrid recurrentgemma-9b, the RWKV-6 (Finch) model rwkv6-1.6b, the
encoder-decoder seamless-m4t-large-v2 and the VLM llama-3.2-vision-90b
(gated cross-attention blocks), the MLA + MoE model deepseek-v2-236b
and the interleaved dense / MoE llama4-maverick-400b-a17b, plus
``reduce_for_smoke``; gemma2-2b's all-local long-context variant
(``gemma2-2b-longctx``, kept out of ``ARCH_NAMES``), which
``config_for_shape`` substitutes for ``long_500k``; and the four input
shapes of ``shapes.py``.

``base.py``, ``shapes.py`` and the ten config modules are verbatim copies
of the JAX package's (imports renamed); ``tests/test_torch_planner.py``
holds them against the originals so the two cannot drift.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

from repro_torch.configs import (
    deepseek_7b,
    deepseek_v2_236b,
    gemma2_2b,
    llama4_maverick_400b_a17b,
    llama_3_2_vision_90b,
    qwen3_4b,
    recurrentgemma_9b,
    rwkv6_1_6b,
    seamless_m4t_large_v2,
    starcoder2_7b,
)
from repro_torch.configs.base import ArchConfig, LayerSpec, MLAConfig, MoEConfig
from repro_torch.configs.shapes import (
    DECODE_32K,
    LONG_500K,
    PREFILL_32K,
    SHAPES,
    SHAPES_BY_NAME,
    TRAIN_4K,
    InputShape,
    get_shape,
)

_REGISTRY: Dict[str, ArchConfig] = {
    m.CONFIG.name: m.CONFIG for m in (gemma2_2b, qwen3_4b, recurrentgemma_9b,
                              rwkv6_1_6b, seamless_m4t_large_v2,
                              llama_3_2_vision_90b, starcoder2_7b,
                              deepseek_7b, deepseek_v2_236b,
                              llama4_maverick_400b_a17b)
}
# gemma2 long-context variant (all-local) used only for long_500k.
_REGISTRY[gemma2_2b.LONG_CONTEXT_CONFIG.name] = gemma2_2b.LONG_CONTEXT_CONFIG

ARCH_NAMES = tuple(
    n for n in _REGISTRY if not n.endswith("-longctx")
)  # the 10 assigned ids


def get_config(name: str) -> ArchConfig:
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def config_for_shape(name: str, shape_name: str) -> ArchConfig:
    """Arch config to use for a given input shape (handles the gemma2
    long-context sliding-window variant substitution)."""
    cfg = get_config(name)
    if shape_name == "long_500k" and name == "gemma2-2b":
        return _REGISTRY["gemma2-2b-longctx"]
    return cfg


def reduce_for_smoke(cfg: ArchConfig, n_layers: int = 2) -> ArchConfig:
    """Shrink a config to smoke-test size: <=2 layers (one pattern period if
    longer), d_model<=512, <=4 experts, tiny vocab — same family and block
    types, runnable on CPU in one forward/train step."""
    n_layers = max(n_layers, min(len(cfg.layer_pattern), 3))
    d_model = 256
    n_heads = min(cfg.n_heads, 4)
    n_kv = max(1, min(cfg.n_kv_heads, n_heads))
    while n_heads % n_kv:
        n_kv -= 1
    head_dim = 32
    moe = None
    if cfg.moe is not None:
        moe = dataclasses.replace(
            cfg.moe,
            n_experts=4,
            experts_per_token=min(cfg.moe.experts_per_token, 2),
            n_shared_experts=min(cfg.moe.n_shared_experts, 1),
            d_expert=128,
            first_k_dense=min(cfg.moe.first_k_dense, 1),
        )
    mla = None
    if cfg.mla is not None:
        mla = MLAConfig(
            kv_lora_rank=64,
            q_lora_rank=96,
            qk_nope_head_dim=32,
            qk_rope_head_dim=16,
            v_head_dim=32,
        )
    return dataclasses.replace(
        cfg,
        name=cfg.name + "-smoke",
        n_layers=n_layers,
        d_model=d_model,
        n_heads=n_heads,
        n_kv_heads=n_kv,
        head_dim=head_dim,
        d_ff=512,
        vocab_size=512,
        sliding_window=min(cfg.sliding_window, 64) if cfg.sliding_window else 0,
        moe=moe,
        mla=mla,
        lru_width=d_model if cfg.lru_width else 0,
        n_encoder_layers=2 if cfg.is_encoder_decoder else 0,
        n_modal_tokens=16 if cfg.n_modal_tokens else 0,
        embedding_multiplier=(
            float(int(d_model**0.5)) if cfg.embedding_multiplier != 1.0 else 1.0
        ),
    )


__all__ = [
    "ArchConfig",
    "LayerSpec",
    "MLAConfig",
    "MoEConfig",
    "InputShape",
    "SHAPES",
    "SHAPES_BY_NAME",
    "TRAIN_4K",
    "PREFILL_32K",
    "DECODE_32K",
    "LONG_500K",
    "ARCH_NAMES",
    "get_config",
    "get_shape",
    "config_for_shape",
    "reduce_for_smoke",
]
