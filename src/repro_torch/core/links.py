"""Per-link communication cost models (heterogeneous-links lever).

DeFT's third lever prices a secondary (slow) link with one scalar
``mu`` — a pure inverse-bandwidth ratio.  Real multi-NIC links differ in
*both* startup latency and bandwidth (MG-WFBP's ``alpha + beta * n``
merge model), and a chain-routed ring schedule adds per-hop permutation
rounds that behave like latency, not like bandwidth.  :class:`LinkModel`
carries both terms; everything downstream (simulator FIFO links,
scheduler knapsack pricing, planner candidate scoring, calibration,
attribution) prices link ``l`` through ``LinkModel.time``.

Durations are *nominal primary-link seconds* — the bucket cost model
(``HardwareModel.allreduce_time``) already converts bytes to seconds at
primary-link speed, so ``inv_bw`` is a ratio relative to that link and
the legacy scalar model is exactly ``LinkModel(0.0, mu)``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict


@dataclasses.dataclass(frozen=True)
class LinkModel:
    """Transfer cost ``latency + duration * inv_bw`` on one link.

    ``inv_bw``   — inverse-bandwidth factor relative to the primary link
                   (>1 = slower; the legacy ``mu``).
    ``latency``  — fixed per-transfer startup cost in seconds; on a
                   chain-routed link it absorbs the ring schedule's
                   per-hop permutation rounds.

    Zero or negative durations cost nothing (no transfer issued).
    """

    latency: float = 0.0
    inv_bw: float = 1.0

    def time(self, duration: float) -> float:
        if duration <= 0.0:
            return 0.0
        return self.latency + duration * self.inv_bw

    @staticmethod
    def pair_from_mu(mu: float) -> Dict[int, "LinkModel"]:
        """The legacy two-link model: unit primary, ``mu``-scaled
        secondary, no latency term."""
        return {0: LinkModel(0.0, 1.0), 1: LinkModel(0.0, mu)}


def effective_mu(models: Dict[int, LinkModel]) -> float:
    """Scalar ``mu`` equivalent of a two-link model (secondary inverse
    bandwidth over primary's) — the backward-compatible summary consumed
    by code that still thinks in ratios."""
    p = models.get(0, LinkModel())
    s = models.get(1, LinkModel())
    return s.inv_bw / max(p.inv_bw, 1e-12)
