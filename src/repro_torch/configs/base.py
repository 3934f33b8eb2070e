"""Architecture configuration schema.

Every assigned architecture is expressed as an :class:`ArchConfig`: a
transformer backbone described by a *repeating layer pattern* of
:class:`LayerSpec` entries.  The pattern is tiled to ``n_layers`` (with a
remainder prefix handled by the model code), which lets the model stack be
built with ``jax.lax.scan`` over whole pattern periods — keeping the lowered
HLO size O(period), not O(n_layers), which matters for the 512-device
dry-run compiles.

The config also carries everything the analytical profiler needs to derive
per-bucket compute/communication times for the DeFT scheduler (parameter
counts per layer, FLOPs per token, activation bytes).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

# Attention-ish sequence mixers.
ATTN_KINDS = ("attn", "local_attn", "mla", "cross_attn")
# Recurrent (attention-free) sequence mixers — these make long_500k feasible.
RECURRENT_KINDS = ("rglru", "rwkv")


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    """One layer of the repeating pattern.

    kind: sequence-mixer type —
        'attn'        full (global) causal self-attention
        'local_attn'  sliding-window causal self-attention
        'mla'         multi-head latent attention (DeepSeek-V2)
        'cross_attn'  cross-attention to encoder / modality memory
                      (paired with a self-attention sublayer in enc-dec
                      decoders; standalone gated layer for VLM)
        'rglru'       RG-LRU gated linear recurrence (Griffin/RecurrentGemma)
        'rwkv'        RWKV-6 time-mix recurrence
    ffn: feed-forward type — 'dense' | 'moe'
    """

    kind: str = "attn"
    ffn: str = "dense"

    def __post_init__(self):
        assert self.kind in ATTN_KINDS + RECURRENT_KINDS, self.kind
        assert self.ffn in ("dense", "moe"), self.ffn


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    experts_per_token: int
    n_shared_experts: int = 0
    d_expert: int = 0            # per-expert FFN hidden size
    router_aux_coef: float = 0.001
    # Layers at the start of the stack that stay dense even if the pattern
    # says 'moe' (DeepSeek-V2 keeps layer 0 dense).
    first_k_dense: int = 0


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    """Multi-head latent attention (DeepSeek-V2, arXiv:2405.04434)."""

    kv_lora_rank: int = 512
    q_lora_rank: int = 1536
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                 # dense | moe | ssm | hybrid | audio | vlm
    citation: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    layer_pattern: Tuple[LayerSpec, ...] = (LayerSpec(),)
    head_dim: int = 0           # 0 -> d_model // n_heads

    # --- attention details -------------------------------------------------
    rope_theta: float = 10_000.0
    use_qk_norm: bool = False
    sliding_window: int = 0     # window size for 'local_attn' layers
    attn_logit_softcap: float = 0.0
    final_logit_softcap: float = 0.0

    # --- norms / FFN --------------------------------------------------------
    norm: str = "rmsnorm"       # rmsnorm | layernorm
    post_block_norm: bool = False   # gemma2-style post-norms
    ffn_activation: str = "silu"    # silu (gated) | gelu (gated) | gelu_mlp
    tie_embeddings: bool = True
    embedding_multiplier: float = 1.0   # gemma scales embeds by sqrt(d_model)

    # --- optional sub-configs ----------------------------------------------
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None

    # --- recurrence (RG-LRU / RWKV-6) ---------------------------------------
    lru_width: int = 0          # 0 -> d_model
    conv1d_width: int = 4       # temporal conv in recurrentgemma recurrent blk

    # --- encoder-decoder / multimodal ---------------------------------------
    is_encoder_decoder: bool = False
    n_encoder_layers: int = 0
    # modality of the *frontend* whose embeddings we consume pre-computed.
    modality: str = "text"      # text | audio | vision
    n_modal_tokens: int = 0     # length of stub modality memory (per example)

    # ------------------------------------------------------------------------
    def __post_init__(self):
        assert self.family in ("dense", "moe", "ssm", "hybrid", "audio", "vlm")
        assert self.n_heads % self.n_kv_heads == 0 or self.mla is not None
        if self.moe is not None:
            assert any(s.ffn == "moe" for s in self.layer_pattern)

    # --- derived quantities --------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def resolved_lru_width(self) -> int:
        return self.lru_width or self.d_model

    @property
    def pattern_period(self) -> int:
        return len(self.layer_pattern)

    def layer_specs(self) -> Tuple[LayerSpec, ...]:
        """The pattern tiled out to n_layers (decoder stack)."""
        reps = math.ceil(self.n_layers / self.pattern_period)
        return (self.layer_pattern * reps)[: self.n_layers]

    def is_recurrent(self) -> bool:
        """True if the arch has at least one recurrent mixer layer."""
        return any(s.kind in RECURRENT_KINDS for s in self.layer_pattern)

    def supports_long_context(self) -> bool:
        """long_500k is runnable iff no layer needs a full-length KV cache."""
        if self.is_encoder_decoder:
            # enc-dec decoder layers carry a full self-attention sublayer.
            return False
        return all(
            s.kind in RECURRENT_KINDS + ("local_attn", "cross_attn")
            for s in self.layer_pattern
        )

    def has_decode_step(self) -> bool:
        """Encoder-only models have no autoregressive decode."""
        return True  # all assigned archs are decoders or enc-dec

    # --- parameter accounting (used by profiler + bucketing) -----------------
    def _attn_params(self, spec: LayerSpec) -> int:
        d, hd = self.d_model, self.resolved_head_dim
        if spec.kind == "mla":
            m = self.mla
            qk_head = m.qk_nope_head_dim + m.qk_rope_head_dim
            p = d * m.q_lora_rank                      # q down
            p += m.q_lora_rank * self.n_heads * qk_head  # q up
            p += d * (m.kv_lora_rank + m.qk_rope_head_dim)  # kv down (+rope k)
            p += m.kv_lora_rank * self.n_heads * (m.qk_nope_head_dim + m.v_head_dim)
            p += self.n_heads * m.v_head_dim * d       # o proj
            return p
        q = d * self.n_heads * hd
        kv = 2 * d * self.n_kv_heads * hd
        o = self.n_heads * hd * d
        p = q + kv + o
        if spec.kind == "cross_attn":
            p += d  # gating scalar-ish (negligible); keep symmetric count
        return p

    def _recurrent_params(self, spec: LayerSpec) -> int:
        d, w = self.d_model, self.resolved_lru_width
        if spec.kind == "rglru":
            # input/gate projections d->w (x2), conv1d, lru gates (a, input
            # gate: w x w/heads block-diag ~ 2*w*w/heads), out proj w->d
            heads = self.n_heads
            return 2 * d * w + self.conv1d_width * w + 2 * w * (w // heads) + w * d + w
        # rwkv6 time-mix: r,k,v,g,o projections + decay/mix params
        return 5 * d * d + 6 * d + 2 * d * 32  # lora-ish ddlerp params

    def _ffn_params(self, spec: LayerSpec, layer_idx: int) -> int:
        d = self.d_model
        if spec.ffn == "moe" and self.moe and layer_idx >= self.moe.first_k_dense:
            me = self.moe
            de = me.d_expert or self.d_ff
            per_expert = 3 * d * de  # gated: up, gate, down
            total = (me.n_experts + me.n_shared_experts) * per_expert
            total += d * me.n_experts  # router
            return total
        mult = 3 if self.ffn_activation in ("silu", "gelu") else 2
        return mult * d * self.d_ff

    def layer_param_counts(self) -> Tuple[int, ...]:
        """Parameter count of each decoder layer, input->output order."""
        counts = []
        for i, spec in enumerate(self.layer_specs()):
            if spec.kind in RECURRENT_KINDS:
                mix = self._recurrent_params(spec)
            else:
                mix = self._attn_params(spec)
                if spec.kind == "cross_attn" and self.family == "vlm":
                    pass  # standalone cross layer: same proj sizes
            ffn = self._ffn_params(spec, i)
            norms = 2 * self.d_model * (2 if self.post_block_norm else 1)
            counts.append(mix + ffn + norms)
        return tuple(counts)

    def embed_params(self) -> int:
        p = self.vocab_size * self.d_model
        if not self.tie_embeddings:
            p *= 2
        return p

    def encoder_param_count(self) -> int:
        if not self.is_encoder_decoder:
            return 0
        # encoder layers: self-attn + dense FFN, same dims
        per = self._attn_params(LayerSpec("attn")) + self._ffn_params(
            LayerSpec("attn", "dense"), 0
        ) + 2 * self.d_model
        return per * self.n_encoder_layers

    def total_params(self) -> int:
        return (
            sum(self.layer_param_counts())
            + self.embed_params()
            + self.encoder_param_count()
            + self.d_model  # final norm
        )

    def active_params(self) -> int:
        """Parameters touched per token (MoE: only routed-active experts)."""
        if self.moe is None:
            return self.total_params()
        me = self.moe
        de = me.d_expert or self.d_ff
        per_expert = 3 * self.d_model * de
        n_moe_layers = sum(
            1
            for i, s in enumerate(self.layer_specs())
            if s.ffn == "moe" and i >= me.first_k_dense
        )
        inactive = n_moe_layers * (me.n_experts - me.experts_per_token) * per_expert
        return self.total_params() - inactive

    # --- FLOPs per token (fwd). bwd ~ 2x fwd. -------------------------------
    def flops_per_token_fwd(self, seq_len: int, causal: bool = True) -> float:
        """Matmul FLOPs per token of forward pass (attention score term
        included, averaged over positions for causal)."""
        f = 2.0 * self.active_params()  # dense matmul term: 2*N_active
        # attention quadratic term
        hd = self.resolved_head_dim
        for spec in self.layer_specs():
            if spec.kind in ("attn", "mla"):
                ctx = seq_len / 2 if causal else seq_len
            elif spec.kind == "local_attn":
                ctx = min(self.sliding_window or seq_len, seq_len)
            elif spec.kind == "cross_attn":
                ctx = max(self.n_modal_tokens, 1)
            else:
                # recurrence: linear state update ~ O(w * w/heads) per token,
                # already approximated by param-count term.
                continue
            nh = self.n_heads
            if spec.kind == "mla":
                hd_eff = self.mla.qk_nope_head_dim + self.mla.qk_rope_head_dim
                f += 2.0 * nh * ctx * (hd_eff + self.mla.v_head_dim)
            else:
                f += 2.0 * nh * ctx * 2 * hd
        return f
