"""Per-bucket wire precision as a scheduling lever (DESIGN.md §13).

The DeFT knapsack prices communication items in seconds derived from
bytes; historically every layer of this repo assumed 4 bytes/element on
the wire (``Bucket.bytes_fp32``).  :class:`PrecisionPolicy` makes the
byte width a first-class, per-bucket decision the planner can trade
against capacity exactly like k-seq and partition changes:

* ``wire[b]`` names the dtype bucket ``b``'s gradients (and, on the
  decoupled sharded engine, its parameter all-gather) travel in — one
  of ``f32`` (4 B), ``bf16`` (2 B), ``int8`` (1 B, blockwise-scaled).
* ``master`` names the resident dtype of the flat parameter/moment
  buffers — ``f32`` (exact) or ``bf16sr`` (stochastic-rounded bf16
  master, halving resident state for the 236B/400B memory envelope).

Pricing rule: a collective's latency term is size-independent, so only
the bandwidth term scales::

    t(policy) = latency + (t_f32 - latency) * wire_bytes / 4

Preserver gate: quantization adds zero-mean noise to each applied
update.  We fold it into the Gaussian-walk check by inflating the walk's
``sigma`` with the byte-weighted mean relative quantization error
(:func:`precision_walk`); a policy is adoptable only when
``check_schedule`` still passes under the inflated noise — the same
accept band that gates k-seq and partition changes.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

from repro_torch.core.bucket import BucketTimes
from repro_torch.core.preserver import (
    PreserverVerdict,
    WalkParams,
    check_schedule,
    rollout,
    verdict_ok,
)

# Wire dtypes, cheapest-first for the planner's downgrade ladder.
WIRE_DTYPES: Tuple[str, ...] = ("f32", "bf16", "int8")
WIRE_BYTES: Dict[str, int] = {"f32": 4, "bf16": 2, "int8": 1}
MASTER_DTYPES: Tuple[str, ...] = ("f32", "bf16sr")

# Conservative per-element RELATIVE quantization noise (std / magnitude)
# used only for the Preserver's sigma inflation — not an accuracy claim.
# bf16 keeps 8 mantissa bits -> rounding step 2^-8 of the value, uniform
# rounding noise std = step/sqrt(12); int8 blockwise (scale = amax/127)
# rounds in steps of amax/127, and amax/|x| is bounded by the block's
# dynamic range — 1/127/sqrt(12) per unit amax is the honest per-element
# bound we inflate with (elements far below amax see relatively more).
WIRE_REL_NOISE: Dict[str, float] = {
    "f32": 0.0,
    "bf16": (2.0 ** -8) / (12.0 ** 0.5),
    "int8": (1.0 / 127.0) / (12.0 ** 0.5),
}

# How strongly relative quantization noise couples into the walk's sigma.
# The walk's sigma is per-example step noise; gradient quantization noise
# is proportional to the step itself, so the coupling is multiplicative
# on sigma with a safety gain (calibrated coarse: int8 everywhere at the
# default eps=0.01 band must NOT pass for an aggressive k-sequence).
PRECISION_SIGMA_GAIN: float = 40.0

# The size-independent latency floor of one collective (matches the
# +20us term in HardwareModel.allreduce_time).
COLLECTIVE_LATENCY_S: float = 20e-6


@dataclasses.dataclass(frozen=True)
class PrecisionPolicy:
    """Per-bucket wire dtypes + resident master dtype.

    ``wire`` is indexed by bucket position (0-based, matching
    ``BucketTimes``/``BucketLayout`` order).  Hashable and frozen so it
    can ride on :class:`~repro_torch.train.bucketing.BucketLayout` and key the
    runtime's phase cache.
    """

    wire: Tuple[str, ...]
    master: str = "f32"

    def __post_init__(self):
        object.__setattr__(self, "wire", tuple(self.wire))
        self.validate()

    @staticmethod
    def uniform(n_buckets: int, wire: str = "f32",
                master: str = "f32") -> "PrecisionPolicy":
        return PrecisionPolicy(wire=(wire,) * n_buckets, master=master)

    def validate(self, n_buckets: Optional[int] = None) -> None:
        for w in self.wire:
            if w not in WIRE_BYTES:
                raise ValueError(
                    f"unknown wire dtype {w!r}; choose from {WIRE_DTYPES}"
                )
        if self.master not in MASTER_DTYPES:
            raise ValueError(
                f"unknown master dtype {self.master!r}; "
                f"choose from {MASTER_DTYPES}"
            )
        if n_buckets is not None and len(self.wire) != n_buckets:
            raise ValueError(
                f"policy covers {len(self.wire)} buckets, layout has "
                f"{n_buckets}"
            )

    # ---- queries --------------------------------------------------------
    def wire_bytes_per_elem(self, b: int) -> int:
        return WIRE_BYTES[self.wire[b]]

    @property
    def n(self) -> int:
        return len(self.wire)

    @property
    def mixed(self) -> bool:
        return len(set(self.wire)) > 1

    @property
    def all_f32(self) -> bool:
        return all(w == "f32" for w in self.wire) and self.master == "f32"

    def describe(self) -> str:
        """Compact human tag, e.g. ``bf16x3+int8x2/f32`` or ``f32``."""
        counts: Dict[str, int] = {}
        for w in self.wire:
            counts[w] = counts.get(w, 0) + 1
        wires = "+".join(
            f"{w}x{counts[w]}" if counts[w] > 1 else w
            for w in WIRE_DTYPES if w in counts
        )
        return wires if self.master == "f32" else f"{wires}/{self.master}"

    def with_wire(self, b: int, wire: str) -> "PrecisionPolicy":
        new = list(self.wire)
        new[b] = wire
        return dataclasses.replace(self, wire=tuple(new))


def scale_comm_time(t_f32: float, bytes_per_elem: int,
                    latency_s: float = COLLECTIVE_LATENCY_S) -> float:
    """Re-price one collective's f32 duration at a narrower wire width.

    Only the bandwidth term shrinks; the latency floor is fixed.  A
    duration already at/below the floor (tiny bucket) is returned as-is.
    """
    bw_term = t_f32 - latency_s
    if bw_term <= 0.0:
        return t_f32
    return latency_s + bw_term * (bytes_per_elem / 4.0)


def apply_wire_precision(
    times: BucketTimes,
    policy: PrecisionPolicy,
    latency_s: float = COLLECTIVE_LATENCY_S,
) -> BucketTimes:
    """Price a profiled :class:`BucketTimes` at the policy's wire widths.

    Everything downstream (knapsack capacities, ``rs_times``/``ag_times``
    split, the timeline simulator) consumes seconds, so this is the ONE
    place precision enters the planning pipeline.
    """
    policy.validate(times.n)
    comm = tuple(
        scale_comm_time(times.comm[b], policy.wire_bytes_per_elem(b),
                        latency_s)
        for b in range(times.n)
    )
    return dataclasses.replace(times, comm=comm)


def wire_bytes_total(
    elems: Sequence[int], policy: Optional[PrecisionPolicy]
) -> int:
    """Total wire bytes for per-bucket element counts under a policy
    (f32 when ``policy`` is None) — the obs layer's planned-bytes side."""
    if policy is None:
        return 4 * sum(elems)
    policy.validate(len(tuple(elems)))
    return sum(n * policy.wire_bytes_per_elem(b)
               for b, n in enumerate(elems))


def quantization_noise_factor(
    policy: PrecisionPolicy,
    weights: Optional[Sequence[float]] = None,
    gain: float = PRECISION_SIGMA_GAIN,
) -> float:
    """Multiplicative sigma-inflation for the Preserver walk.

    ``weights`` are per-bucket contribution weights (typically the f32
    comm-time fractions, a bytes proxy); default uniform.  Returns
    ``1 + gain * sum_b w_b * rel_noise(wire[b])`` — exactly 1.0 for an
    all-f32 wire, so the gate is a no-op there.
    """
    n = policy.n
    if weights is None:
        w = [1.0 / max(n, 1)] * n
    else:
        tot = sum(weights)
        w = [x / tot for x in weights] if tot > 0 else [0.0] * n
    noise = sum(w[b] * WIRE_REL_NOISE[policy.wire[b]] for b in range(n))
    if policy.master == "bf16sr":
        # the stochastic-rounded master adds one more rounding per write
        noise += WIRE_REL_NOISE["bf16"]
    return 1.0 + gain * noise


def precision_walk(
    walk: WalkParams,
    policy: PrecisionPolicy,
    times: Optional[BucketTimes] = None,
    gain: float = PRECISION_SIGMA_GAIN,
) -> WalkParams:
    """Inflate a walk's sigma with the policy's quantization noise.

    With ``times`` the per-bucket weights are the f32 comm-time
    fractions (bigger buckets carry more quantized mass); without, the
    weighting is uniform.  The Preserver then gates the (schedule,
    policy) pair jointly: ``check_schedule(ks, period,
    precision_walk(walk, policy, times), eps)``.
    """
    weights = times.comm if times is not None else None
    factor = quantization_noise_factor(policy, weights, gain)
    if factor == 1.0:
        return walk
    return dataclasses.replace(walk, sigma=walk.sigma * factor)


def check_precision_schedule(
    batch_size_sequence: Sequence[int],
    period: int,
    walk: WalkParams,
    policy: PrecisionPolicy,
    times: Optional[BucketTimes] = None,
    eps: float = 0.01,
    gain: float = PRECISION_SIGMA_GAIN,
) -> PreserverVerdict:
    """Preserver gate for a (k-sequence, precision policy) pair.

    The fixed-B reference ``O_B`` trains unquantized, so it rolls the
    CLEAN walk; DeFT's variable sequence ``O_D`` carries the policy's
    quantization noise (inflated sigma).  This makes the gate strictly
    one-sided in precision: narrowing the wire can only push the ratio
    down, never rescue a failing k-sequence.  An all-f32 policy reduces
    exactly to :func:`~repro_torch.core.preserver.check_schedule`.
    """
    inflated = precision_walk(walk, policy, times, gain)
    if inflated is walk:
        return check_schedule(batch_size_sequence, period, walk, eps)
    ks = [float(k) for k in batch_size_sequence]
    if not ks:
        return PreserverVerdict(
            ratio=float("inf"), e_baseline=0.0, e_deft=float("inf"),
            ok=False, eps=eps,
        )
    # no all-ones shortcut here: even the identity k-sequence differs
    # from the reference once its updates are quantized
    e_b = rollout([1.0] * period, walk)
    e_d = rollout(ks, inflated)
    denom = e_d - walk.s_star
    numer = e_b - walk.s_star
    ratio = numer / denom if abs(denom) > 1e-30 else float("inf")
    return PreserverVerdict(
        ratio=ratio, e_baseline=e_b, e_deft=e_d,
        ok=verdict_ok(ratio, eps), eps=eps,
    )
