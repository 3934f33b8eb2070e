"""Analytical profiler — the JAX analogue of the paper's Nsight-trace
reconstruction (§IV.B).

The paper profiles a running PyTorch job with Nsight Systems and rebuilds
operator logs into bucket-level forward/backward/communication times.  On
this CPU container the TPU is a *target*, so we derive the same bucket-level
quantities analytically from the architecture config and a hardware model,
and (when a dry-run compile is available) re-base the totals against
``compiled.cost_analysis()`` so the scheduler consumes compiler-grounded
numbers rather than napkin ones.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

from repro_torch.configs.base import ArchConfig
from repro_torch.core.bucket import Bucket, BucketTimes, build_buckets, model_layer_elems


@dataclasses.dataclass(frozen=True)
class HardwareModel:
    """TPU v5e-like chip + interconnect model (assignment constants)."""

    chip_flops: float = 197e12        # bf16 peak FLOP/s
    hbm_bw: float = 819e9             # bytes/s
    ici_bw: float = 50e9              # bytes/s per link (primary)
    mu: float = 1.65                  # primary/secondary speed ratio (paper)
    mfu: float = 0.45                 # assumed compute efficiency
    dp_degree: int = 16               # devices participating in grad allreduce
    grad_bytes_per_elem: int = 4      # fp32 gradient sync

    @property
    def secondary_bw(self) -> float:
        return self.ici_bw / self.mu

    def allreduce_time(
        self,
        n_elements: int,
        link_bw: Optional[float] = None,
        bytes_per_elem: Optional[int] = None,
    ) -> float:
        """Ring all-reduce wall time for one gradient bucket.

        ``bytes_per_elem`` prices a narrower wire dtype (a
        :class:`~repro_torch.core.precision.PrecisionPolicy` choice); the
        +20us launch latency is size-independent and does NOT scale."""
        bw = self.ici_bw if link_bw is None else link_bw
        d = self.dp_degree
        bpe = self.grad_bytes_per_elem if bytes_per_elem is None else bytes_per_elem
        vol = 2.0 * (d - 1) / d * n_elements * bpe
        # per-launch startup latency (the paper's motivation for fusion)
        return vol / bw + 20e-6

    def compute_time(self, flops: float) -> float:
        return flops / (self.chip_flops * self.mfu)


@dataclasses.dataclass(frozen=True)
class Profile:
    """Everything the Solver consumes."""

    cfg: ArchConfig
    hw: HardwareModel
    buckets: List[Bucket]
    times: BucketTimes

    @property
    def coverage_rate(self) -> float:
        return self.times.coverage_rate


def _layer_flops_fwd(cfg: ArchConfig, seq_len: int, per_device_batch: int) -> List[float]:
    """Forward FLOPs per 'layer entry' (embedding, decoder layers, head) —
    matches model_layer_elems ordering."""
    tokens = per_device_batch * seq_len
    specs = cfg.layer_specs()
    elems = model_layer_elems(cfg)
    out: List[float] = []
    # embedding lookup is gather (negligible matmul FLOPs); encoder flops
    # are folded in if enc-dec.
    enc_flops = 0.0
    if cfg.is_encoder_decoder:
        enc_flops = 2.0 * cfg.encoder_param_count() * tokens
    out.append(enc_flops + 2.0 * tokens * cfg.d_model)  # embed scale etc.
    hd = cfg.resolved_head_dim
    for i, spec in enumerate(specs):
        # matmul term: 2 * active params of this layer
        if spec.ffn == "moe" and cfg.moe and i >= cfg.moe.first_k_dense:
            me = cfg.moe
            de = me.d_expert or cfg.d_ff
            active = (
                cfg._attn_params(spec)
                + (me.experts_per_token + me.n_shared_experts) * 3 * cfg.d_model * de
                + cfg.d_model * me.n_experts
            )
        else:
            active = elems[1 + i]
        f = 2.0 * active * tokens
        # attention quadratic term
        if spec.kind in ("attn", "mla"):
            ctx = seq_len / 2
        elif spec.kind == "local_attn":
            ctx = min(cfg.sliding_window or seq_len, seq_len)
        elif spec.kind == "cross_attn":
            ctx = max(cfg.n_modal_tokens, 1)
        else:
            ctx = 0
        if ctx:
            if spec.kind == "mla":
                hde = cfg.mla.qk_nope_head_dim + cfg.mla.qk_rope_head_dim + cfg.mla.v_head_dim
            else:
                hde = 2 * hd
            f += 2.0 * tokens * cfg.n_heads * ctx * hde
        out.append(f)
    # LM head
    out.append(2.0 * tokens * cfg.d_model * cfg.vocab_size * (0 if cfg.tie_embeddings else 1))
    if cfg.tie_embeddings:
        out[-1] = 2.0 * tokens * cfg.d_model * cfg.vocab_size  # tied head still matmuls
    return out


def profile_arch(
    cfg: ArchConfig,
    hw: HardwareModel = HardwareModel(),
    seq_len: int = 4096,
    per_device_batch: int = 1,
    partition_strategy: str = "deft",
    partition_elems: int = 6_500_000,
    rebase_total_flops: Optional[float] = None,
) -> Profile:
    """Build buckets and derive their fwd/bwd/comm times.

    rebase_total_flops: if given (from compiled.cost_analysis()), scale all
    per-layer FLOPs so their total matches the compiler's count.
    """
    layer_flops = _layer_flops_fwd(cfg, seq_len, per_device_batch)
    if rebase_total_flops:
        scale = rebase_total_flops / max(sum(layer_flops) * 3.0, 1.0)
        layer_flops = [f * scale for f in layer_flops]

    # smallest knapsack capacity ~ fwd_time / mu (paper §III.D)
    fwd_total = sum(hw.compute_time(f) for f in layer_flops)
    buckets = build_buckets(
        cfg,
        strategy=partition_strategy,
        partition_elems=partition_elems,
        comm_time_of=lambda n: hw.allreduce_time(n),
        max_comm_time=fwd_total / hw.mu if partition_strategy == "deft" else float("inf"),
    )

    layer_elems = model_layer_elems(cfg)
    # distribute layer flops to buckets proportionally to covered elements
    fwd, bwd, comm = [], [], []
    for b in buckets:
        f = 0.0
        for lid in b.layer_ids:
            share = b.n_elements / max(
                sum(bb.n_elements for bb in buckets if lid in bb.layer_ids), 1
            )
            f += layer_flops[lid if lid >= 0 else 0] * (
                share if b.split else 1.0 / _n_buckets_covering(buckets, lid)
            )
        fwd.append(hw.compute_time(f))
        bwd.append(hw.compute_time(2.0 * f))
        comm.append(hw.allreduce_time(b.n_elements))
    assert abs(sum(b.n_elements for b in buckets) - sum(layer_elems)) < max(layer_elems)
    return Profile(cfg=cfg, hw=hw, buckets=buckets, times=BucketTimes(tuple(fwd), tuple(bwd), tuple(comm)))


def _n_buckets_covering(buckets: Sequence[Bucket], lid: int) -> int:
    return max(1, sum(1 for b in buckets if lid in b.layer_ids))
