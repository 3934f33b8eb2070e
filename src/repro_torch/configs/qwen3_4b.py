"""qwen3-4b [dense] — GQA with per-head qk RMSNorm. [hf:Qwen/Qwen3-8B]

36L d_model=2560 32H (GQA kv=8) d_ff=9728 vocab=151936.
"""
from repro_torch.configs.base import ArchConfig, LayerSpec

CONFIG = ArchConfig(
    name="qwen3-4b",
    family="dense",
    citation="hf:Qwen/Qwen3-8B",
    n_layers=36,
    d_model=2560,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=9728,
    vocab_size=151_936,
    layer_pattern=(LayerSpec("attn", "dense"),),
    use_qk_norm=True,
    rope_theta=1_000_000.0,
    norm="rmsnorm",
    ffn_activation="silu",
    tie_embeddings=True,
)
