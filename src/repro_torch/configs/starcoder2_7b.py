"""starcoder2-7b [dense] — GQA + RoPE + sliding window 4096, LayerNorm,
non-gated GELU MLP. [arXiv:2402.19173]

32L d_model=4608 36H (GQA kv=4) d_ff=18432 vocab=49152.
"""
from repro_torch.configs.base import ArchConfig, LayerSpec

CONFIG = ArchConfig(
    name="starcoder2-7b",
    family="dense",
    citation="arXiv:2402.19173",
    n_layers=32,
    d_model=4608,
    n_heads=36,
    n_kv_heads=4,
    head_dim=128,
    d_ff=18432,
    vocab_size=49_152,
    # StarCoder2-7B trains with a 4k sliding window over a 16k context.
    layer_pattern=(LayerSpec("local_attn", "dense"),),
    sliding_window=4096,
    rope_theta=1_000_000.0,
    norm="layernorm",
    ffn_activation="gelu_mlp",
    tie_embeddings=True,
)
