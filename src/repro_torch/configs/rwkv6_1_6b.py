"""rwkv6-1.6b [ssm] — Finch: data-dependent decay linear recurrence,
attention-free. [arXiv:2404.05892]

24L d_model=2048 d_ff=7168 vocab=65536; time-mix head size 64.
"""
from repro_torch.configs.base import ArchConfig, LayerSpec

CONFIG = ArchConfig(
    name="rwkv6-1.6b",
    family="ssm",
    citation="arXiv:2404.05892",
    n_layers=24,
    d_model=2048,
    n_heads=32,            # time-mix heads: d_model / 64
    n_kv_heads=32,
    head_dim=64,
    d_ff=7168,
    vocab_size=65_536,
    layer_pattern=(LayerSpec("rwkv", "dense"),),
    norm="layernorm",
    ffn_activation="gelu_mlp",   # rwkv channel-mix is a square-relu 2-mat MLP
    tie_embeddings=False,
)
