"""Butterfly All-Reduce (paper section 5), the dense half (mirrors
``repro/core/butterfly.py``): pair-indexed shards, 2x redundancy,
agreement-matrix verification.

For N miners on one layer, enumerate all pairs (i, j), i < j, and apply a
seeded random bijection from pairs to shards; shard s of the flattened
parameter vector is reduced by both miners of its pair.  Every shard so has
two independent reduced copies: the agreement matrix compares them (a
deceptive reducer disagrees with every partner), and a shard is lost only if
both of its reducers fail.

``ButterflyPlan`` + ``reduce_shards`` run the reduce centrally over
in-memory vectors, the golden oracle of the dense sync.  Each shard's merge
is ``ops.shard_merge`` (K3 on the card) over the miners' uploads, stacked
once on ``device``; the merged values come back to numpy, as in the
reference.  The store-and-forward ``ButterflyExecutor`` (sharded sync) and
the on-mesh ``butterfly_all_reduce_mesh`` come with later slices.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.common import cdiv, round_up
from repro_torch.kernels import ops


@dataclasses.dataclass(frozen=True)
class ButterflyPlan:
    n_miners: int
    pairs: tuple[tuple[int, int], ...]      # shard s -> (miner_i, miner_j)
    vector_len: int
    # shard boundaries snap to multiples of ``align`` (except the vector end)
    align: int = 1

    @property
    def n_shards(self) -> int:
        return len(self.pairs)

    def shard_bounds(self, s: int) -> tuple[int, int]:
        """Near-equal contiguous slices of the flattened parameter vector;
        with ``align > 1``, near-equal in whole blocks (trailing shards may
        be empty when the vector has fewer blocks than shards)."""
        if self.align == 1:
            base = self.vector_len // self.n_shards
            extra = self.vector_len % self.n_shards
            lo = s * base + min(s, extra)
            hi = lo + base + (1 if s < extra else 0)
            return lo, hi
        blocks = cdiv(self.vector_len, self.align)
        base = blocks // self.n_shards
        extra = blocks % self.n_shards
        blo = s * base + min(s, extra)
        bhi = blo + base + (1 if s < extra else 0)
        return (min(blo * self.align, self.vector_len),
                min(bhi * self.align, self.vector_len))

    def shards_of(self, miner: int) -> list[int]:
        """Shard indices assigned to ``miner`` (one per partner: N-1)."""
        return [s for s, (i, j) in enumerate(self.pairs) if miner in (i, j)]


def make_plan(n_miners: int, vector_len: int, seed: int = 0,
              align: int = 1) -> ButterflyPlan:
    if n_miners < 2:
        raise ValueError(f"a butterfly needs >= 2 miners, got {n_miners}")
    pairs = list(itertools.combinations(range(n_miners), 2))
    rng = np.random.RandomState(seed)
    rng.shuffle(pairs)                       # the random bijection f
    return ButterflyPlan(n_miners, tuple(tuple(p) for p in pairs),
                         vector_len, align)


def _stack(plan: ButterflyPlan, uploads: dict,
           device: str) -> tuple[torch.Tensor, torch.Tensor]:
    """The uploads as one (N, L) f32 matrix on ``device`` (a missing
    miner's row is zeros) and the (N,) validity mask.  Rows are copied in
    one at a time, so the host never holds the stacked matrix, and start
    on 256-byte boundaries (a row stride rounded up to 64 floats), so the
    merge reads every row with 16-byte loads."""
    n, L = plan.n_miners, plan.vector_len
    stacked = torch.zeros((n, round_up(L, 64)), dtype=torch.float32,
                          device=device)[:, :L]
    for m, vec in uploads.items():
        stacked[m].copy_(torch.as_tensor(np.asarray(vec, np.float32)))
    valid = torch.tensor([m in uploads for m in range(n)], device=device)
    return stacked, valid


def reduce_shards(
    plan: ButterflyPlan,
    uploads: dict[int, np.ndarray],          # miner -> full flattened vector
    reducer_ok: Optional[Sequence[bool]] = None,   # reducer miner alive?
    tamper: Optional[dict[int, float]] = None,     # miner -> additive noise
    *, device: str = "cuda",
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Run the full butterfly reduce.

    Returns (merged vector, shard_valid (n_shards,), shard_agree
    (n_shards,)).  Each shard reduction is ``ops.shard_merge`` (masked mean)
    over the uploads stacked on ``device``."""
    n = plan.n_miners
    reducer_ok = list(reducer_ok) if reducer_ok is not None else [True] * n
    tamper = tamper or {}
    merged = np.zeros(plan.vector_len, np.float32)
    shard_valid = np.zeros(plan.n_shards, bool)
    shard_agree = np.ones(plan.n_shards, bool)
    stacked, valid_mask = _stack(plan, uploads, device)

    for s, (i, j) in enumerate(plan.pairs):
        lo, hi = plan.shard_bounds(s)
        if hi == lo:
            shard_valid[s] = True
            continue
        copies = []
        for reducer in (i, j):
            if not reducer_ok[reducer]:
                continue
            mean = ops.shard_merge(stacked[:, lo:hi], valid_mask).cpu().numpy()
            if reducer in tamper:
                mean = mean + tamper[reducer]
            copies.append((reducer, mean))
        if not copies:
            shard_valid[s] = False          # both assignees down: shard lost
            continue
        shard_valid[s] = True
        if len(copies) == 2:
            a, b = copies[0][1], copies[1][1]
            shard_agree[s] = bool(np.allclose(a, b, rtol=1e-4, atol=1e-5))
        merged[lo:hi] = copies[0][1]        # first surviving copy wins
    return merged, shard_valid, shard_agree


def agreement_matrix(
    plan: ButterflyPlan,
    reduced_copies: dict[tuple[int, int], np.ndarray],  # (shard, reducer)
) -> np.ndarray:
    """(N, N) matrix: fraction of shared shards on which each miner pair's
    reduced copies agree (Fig 7a; off-consensus rows expose deceivers)."""
    n = plan.n_miners
    agree = np.full((n, n), np.nan)
    for s, (i, j) in enumerate(plan.pairs):
        a = reduced_copies.get((s, i))
        b = reduced_copies.get((s, j))
        if a is None or b is None:
            continue
        ok = float(np.allclose(a, b, rtol=1e-4, atol=1e-5))
        agree[i, j] = agree[j, i] = ok
    np.fill_diagonal(agree, 1.0)
    return agree


def reduce_with_copies(
    plan: ButterflyPlan,
    uploads: dict[int, np.ndarray],
    tamper: Optional[dict[int, float]] = None,
    *, device: str = "cuda",
) -> dict[tuple[int, int], np.ndarray]:
    """Each reducer's copy of each assigned shard (input to
    ``agreement_matrix``)."""
    tamper = tamper or {}
    stacked, valid_mask = _stack(plan, uploads, device)
    out = {}
    for s, (i, j) in enumerate(plan.pairs):
        lo, hi = plan.shard_bounds(s)
        base = ops.shard_merge(stacked[:, lo:hi], valid_mask).cpu().numpy()
        for reducer in (i, j):
            out[(s, reducer)] = base + tamper.get(reducer, 0.0)
    return out
