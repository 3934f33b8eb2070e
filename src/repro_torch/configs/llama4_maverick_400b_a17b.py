"""llama4-maverick-400b-a17b [moe] — interleaved dense/MoE layers, 128
routed experts top-1 + 1 shared expert, early-fusion multimodal text
backbone. [hf:meta-llama/Llama-4-Scout-17B-16E / Llama-4-Maverick card]

48L d_model=5120 40H (GQA kv=8) d_ff=8192 vocab=202048.
"""
from repro_torch.configs.base import ArchConfig, LayerSpec, MoEConfig

CONFIG = ArchConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    citation="hf:meta-llama/Llama-4-Scout-17B-16E",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=202_048,
    # Maverick interleaves dense and MoE FFN layers 1:1.
    layer_pattern=(
        LayerSpec("attn", "dense"),
        LayerSpec("attn", "moe"),
    ),
    moe=MoEConfig(
        n_experts=128,
        experts_per_token=1,
        n_shared_experts=1,
        d_expert=8192,
        router_aux_coef=0.001,
    ),
    rope_theta=500_000.0,
    use_qk_norm=True,
    norm="rmsnorm",
    ffn_activation="silu",
    tie_embeddings=False,
)
