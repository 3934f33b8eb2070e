"""recurrentgemma-9b [hybrid] — RG-LRU + local attention, 2:1 recurrent:attn
pattern. [arXiv:2402.19427 (Griffin), RecurrentGemma model card]

38L d_model=4096 16H (MQA kv=1) d_ff=12288 vocab=256000, window 2048.
"""
from repro_torch.configs.base import ArchConfig, LayerSpec

CONFIG = ArchConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    citation="arXiv:2402.19427",
    n_layers=38,
    d_model=4096,
    n_heads=16,
    n_kv_heads=1,
    head_dim=256,
    d_ff=12288,
    vocab_size=256_000,
    # Griffin block pattern: (recurrent, recurrent, local attention)
    layer_pattern=(
        LayerSpec("rglru"),
        LayerSpec("rglru"),
        LayerSpec("local_attn"),
    ),
    sliding_window=2048,
    rope_theta=10_000.0,
    norm="rmsnorm",
    ffn_activation="gelu",
    embedding_multiplier=64.0,  # sqrt(d_model) = 64
    lru_width=4096,
    conv1d_width=4,
)
