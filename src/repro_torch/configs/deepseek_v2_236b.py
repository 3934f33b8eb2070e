"""deepseek-v2-236b [moe] — MLA (kv_lora=512) + 2 shared + 160 routed
experts top-6. [arXiv:2405.04434]

60L d_model=5120 128H d_ff(expert)=1536 vocab=102400; first layer dense
(d_ff 12288).
"""
from repro_torch.configs.base import ArchConfig, LayerSpec, MLAConfig, MoEConfig

CONFIG = ArchConfig(
    name="deepseek-v2-236b",
    family="moe",
    citation="arXiv:2405.04434",
    n_layers=60,
    d_model=5120,
    n_heads=128,
    n_kv_heads=128,
    head_dim=128,
    d_ff=12288,                # dense-FFN hidden (layer 0)
    vocab_size=102_400,
    layer_pattern=(LayerSpec("mla", "moe"),),
    mla=MLAConfig(
        kv_lora_rank=512,
        q_lora_rank=1536,
        qk_nope_head_dim=128,
        qk_rope_head_dim=64,
        v_head_dim=128,
    ),
    moe=MoEConfig(
        n_experts=160,
        experts_per_token=6,
        n_shared_experts=2,
        d_expert=1536,
        first_k_dense=1,
        router_aux_coef=0.003,
    ),
    rope_theta=10_000.0,
    norm="rmsnorm",
    ffn_activation="silu",
    tie_embeddings=False,
)
