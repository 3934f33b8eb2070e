"""deepseek-7b [dense] — llama-architecture. [arXiv:2401.02954]

30L d_model=4096 32H (kv=32, i.e. MHA) d_ff=11008 vocab=102400.
"""
from repro_torch.configs.base import ArchConfig, LayerSpec

CONFIG = ArchConfig(
    name="deepseek-7b",
    family="dense",
    citation="arXiv:2401.02954",
    n_layers=30,
    d_model=4096,
    n_heads=32,
    n_kv_heads=32,
    head_dim=128,
    d_ff=11008,
    vocab_size=102_400,
    layer_pattern=(LayerSpec("attn", "dense"),),
    rope_theta=10_000.0,
    norm="rmsnorm",
    ffn_activation="silu",
    tie_embeddings=False,
)
