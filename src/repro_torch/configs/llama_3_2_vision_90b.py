"""llama-3.2-vision-90b [vlm] — llama3 text decoder with gated
cross-attention image layers interleaved. [hf:meta-llama/Llama-3.2-11B-Vision]

100L d_model=8192 64H (GQA kv=8) d_ff=28672 vocab=128256.
The 100 layers comprise 80 self-attention layers + 20 gated cross-attention
layers (1 cross per 4 self, matching the 11B card's 1:5 layer ratio).
The ViT vision encoder + projector is a STUB per the assignment: the model
consumes precomputed patch embeddings (batch, n_patches, d_model).
"""
from repro_torch.configs.base import ArchConfig, LayerSpec

CONFIG = ArchConfig(
    name="llama-3.2-vision-90b",
    family="vlm",
    citation="hf:meta-llama/Llama-3.2-11B-Vision",
    n_layers=100,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=28672,
    vocab_size=128_256,
    layer_pattern=(
        LayerSpec("attn", "dense"),
        LayerSpec("attn", "dense"),
        LayerSpec("attn", "dense"),
        LayerSpec("attn", "dense"),
        LayerSpec("cross_attn", "dense"),
    ),
    modality="vision",
    n_modal_tokens=1601,       # 1 tile x (40x40 patches + cls) per image
    rope_theta=500_000.0,
    norm="rmsnorm",
    ffn_activation="silu",
    tie_embeddings=False,
)
