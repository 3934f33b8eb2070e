"""seamless-m4t-large-v2 [audio] — encoder-decoder text/unit backbone of
SeamlessM4T v2. [arXiv:2308.11596]

24L(enc)+24L(dec) d_model=1024 16H d_ff=8192 vocab=256206.
The speech frontend (w2v-BERT conformer) is a STUB per the assignment: the
model consumes precomputed frame embeddings of shape (batch, n_frames, d).
"""
from repro_torch.configs.base import ArchConfig, LayerSpec

CONFIG = ArchConfig(
    name="seamless-m4t-large-v2",
    family="audio",
    citation="arXiv:2308.11596",
    n_layers=24,               # decoder layers
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    head_dim=64,
    d_ff=8192,
    vocab_size=256_206,
    layer_pattern=(LayerSpec("cross_attn", "dense"),),  # self+cross per layer
    is_encoder_decoder=True,
    n_encoder_layers=24,
    modality="audio",
    n_modal_tokens=1024,       # stub: ~20s of speech at 50 fps
    rope_theta=10_000.0,       # decoder self-attn positions
    norm="layernorm",
    ffn_activation="gelu_mlp",
    tie_embeddings=True,
)
