"""Incentivization (paper §3 + Appendix A).

Scores: a miner earns S_m^n = number of backward passes validated in epoch n.
Each score carries a step-function time decay w(t) = 1[t <= gamma]; the raw
incentive is I_m = sum_n S_m^n * w(t - t_n).  Emissions per interval are
distributed proportionally to I_m.

Appendix A: the number of live scores per miner is N_scores = gamma / T_s
(T_s = full-sync interval).  Incentive *stability* falls as N_scores shrinks
— ``stability_simulation`` reproduces Fig 9's (monitoring time x decay)
sweep by simulating score arrival/expiry and measuring the coefficient of
variation of each miner's emission share.

A copy of ``repro/core/incentives.py`` (numpy only).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass
class ScoreEntry:
    miner: int
    epoch: int
    score: float            # S_m^n: validated backward passes
    t_assigned: float


class IncentiveLedger:
    """Append-only score ledger with step-function decay (paper §3)."""

    def __init__(self, gamma: float):
        self.gamma = float(gamma)
        self.entries: list[ScoreEntry] = []

    def record(self, miner: int, epoch: int, score: float, t: float) -> None:
        assert score >= 0
        self.entries.append(ScoreEntry(miner, epoch, float(score), float(t)))

    def weight(self, entry: ScoreEntry, t_now: float) -> float:
        """w(t): 1 while the score is younger than gamma, else 0."""
        return 1.0 if (t_now - entry.t_assigned) <= self.gamma else 0.0

    def raw_incentive(self, miner: int, t_now: float) -> float:
        return sum(e.score * self.weight(e, t_now)
                   for e in self.entries if e.miner == miner)

    def emissions(self, t_now: float, total_emission: float = 1.0,
                  miners: Optional[list[int]] = None) -> dict[int, float]:
        miners = miners if miners is not None else sorted(
            {e.miner for e in self.entries})
        raw = np.array([self.raw_incentive(m, t_now) for m in miners])
        total = raw.sum()
        if total <= 0:
            share = np.full(len(miners), 1.0 / max(len(miners), 1))
        else:
            share = raw / total
        return {m: float(s * total_emission) for m, s in zip(miners, share)}

    def prune(self, t_now: float) -> None:
        self.entries = [e for e in self.entries
                        if (t_now - e.t_assigned) <= self.gamma]


def expected_live_scores(gamma: float, sync_interval: float) -> float:
    """Appendix A: N_scores = gamma / T_s."""
    return gamma / sync_interval


# ---------------------------------------------------------------------------
# Fig 9: incentive stability vs (monitoring time, decay period)
# ---------------------------------------------------------------------------


def stability_simulation(
    sync_interval_hours: float,
    gamma_hours: float,
    n_miners: int = 32,
    horizon_hours: float = 100.0,
    score_cv: float = 0.3,
    validated_fraction: float = 1.0,
    seed: int = 0,
) -> dict:
    """Simulate epochs of score assignment + expiry; return the mean

    coefficient-of-variation of per-miner emission share over time (low CV
    = stable incentives).  Scores per epoch are noisy (hardware heterogeneity)
    and each miner is only validated with probability ``validated_fraction``
    per epoch (validator coverage)."""
    rng = np.random.RandomState(seed)
    ledger = IncentiveLedger(gamma_hours)
    n_epochs = int(horizon_hours / sync_interval_hours)
    base_rate = rng.lognormal(0.0, 0.25, n_miners)      # heterogeneous hw
    shares = []
    for ep in range(n_epochs):
        t = ep * sync_interval_hours
        for m in range(n_miners):
            if rng.rand() > validated_fraction:
                continue                                 # not monitored
            score = max(rng.normal(base_rate[m], score_cv * base_rate[m]), 0.0)
            ledger.record(m, ep, score, t)
        ledger.prune(t)
        em = ledger.emissions(t, miners=list(range(n_miners)))
        shares.append([em[m] for m in range(n_miners)])
    shares = np.asarray(shares[max(1, int(gamma_hours / sync_interval_hours)):])
    if shares.size == 0:
        return {"cv": np.inf, "n_scores": expected_live_scores(
            gamma_hours, sync_interval_hours)}
    mean = shares.mean(axis=0)
    std = shares.std(axis=0)
    cv = float(np.mean(std / np.maximum(mean, 1e-12)))
    return {
        "cv": cv,
        "n_scores": expected_live_scores(gamma_hours, sync_interval_hours),
        "mean_share": mean.tolist(),
    }
