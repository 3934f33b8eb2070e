"""gemma2-2b [dense] — alternating local(4096)/global attention, attn and
final logit soft-capping, pre+post RMSNorm. [arXiv:2408.00118]

26L d_model=2304 8H (GQA kv=4) d_ff=9216 vocab=256000.
"""
from repro_torch.configs.base import ArchConfig, LayerSpec

CONFIG = ArchConfig(
    name="gemma2-2b",
    family="dense",
    citation="arXiv:2408.00118",
    n_layers=26,
    d_model=2304,
    n_heads=8,
    n_kv_heads=4,
    head_dim=256,
    d_ff=9216,
    vocab_size=256_000,
    layer_pattern=(
        LayerSpec("local_attn", "dense"),
        LayerSpec("attn", "dense"),
    ),
    sliding_window=4096,
    attn_logit_softcap=50.0,
    final_logit_softcap=30.0,
    post_block_norm=True,
    rope_theta=10_000.0,
    norm="rmsnorm",
    ffn_activation="gelu",
    embedding_multiplier=48.0,  # sqrt(2304) = 48
    tie_embeddings=True,
)

# long_500k variant: all-local layers (window 4096) so the decode state is
# O(window), documented in DESIGN.md §long_500k applicability.
LONG_CONTEXT_CONFIG = ArchConfig(
    **{
        **{f.name: getattr(CONFIG, f.name) for f in CONFIG.__dataclass_fields__.values()},  # type: ignore[attr-defined]
        "name": "gemma2-2b-longctx",
        "layer_pattern": (LayerSpec("local_attn", "dense"),),
    }
)
