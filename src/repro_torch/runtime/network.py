"""Fault / straggler / adversary injection (seeded, deterministic).

Models the paper's operating environment: heterogeneous, unreliable,
adversarial.  Each miner gets a ``MinerBehavior``; the orchestrator consults
``FaultModel`` every time it routes work:

  * drop: miner offline this tick (SWARM reroute: resample the pathway)
  * straggle: miner takes ``straggle_factor`` x the base tick — it finishes
    fewer batches, exercising the B_min/B_eff threshold logic
  * tamper_activations: adversarial — adds noise to forward outputs
    (caught by validators' cosine check + CLASP loss attribution)
  * tamper_weights: uploads corrupted weights at merge (caught by the
    butterfly agreement matrix)
  * free_ride: skips compute, emits zeros (caught by CLASP: pathways through
    it have catastrophically high loss)

A copy of ``repro/runtime/network.py`` (numpy only).
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class MinerBehavior:
    drop_prob: float = 0.0
    straggle_factor: float = 1.0         # >1: slower hardware
    tamper_activations: float = 0.0      # noise std added to fwd outputs
    tamper_weights: float = 0.0          # noise std added to weight uploads
    free_ride: bool = False

    @property
    def honest(self) -> bool:
        return (self.tamper_activations == 0 and self.tamper_weights == 0
                and not self.free_ride)


class FaultModel:
    def __init__(self, behaviors: dict[int, MinerBehavior], seed: int = 0):
        self.behaviors = behaviors
        self.rng = np.random.RandomState(seed)

    def behavior(self, miner: int) -> MinerBehavior:
        return self.behaviors.get(miner, MinerBehavior())

    def is_dropped(self, miner: int) -> bool:
        return self.rng.rand() < self.behavior(miner).drop_prob

    def work_ticks(self, miner: int, base: int) -> int:
        """Batches a miner finishes in a window of ``base`` ticks."""
        f = self.behavior(miner).straggle_factor
        return max(int(round(base / max(f, 1e-6))), 0)

    def corrupt_activation(self, miner: int, x: np.ndarray) -> np.ndarray:
        b = self.behavior(miner)
        if b.free_ride:
            return np.zeros_like(x)
        if b.tamper_activations > 0:
            return x + self.rng.randn(*x.shape).astype(x.dtype) * b.tamper_activations
        return x

    def corrupt_weights(self, miner: int, vec: np.ndarray) -> np.ndarray:
        b = self.behavior(miner)
        if b.tamper_weights > 0:
            return vec + self.rng.randn(*vec.shape).astype(vec.dtype) * b.tamper_weights
        return vec
