"""DiLoCo composition (paper section 2.1): inner AdamW steps + outer
Nesterov merge (mirrors the host-side half of ``repro/core/diloco.py``).

Each miner runs local optimizer steps; at a merge event the qualifying
miners' parameters are averaged through the butterfly all-reduce and applied
to the shared per-stage anchor by an outer Nesterov-momentum step.  The
on-mesh half (``outer_merge_step`` over ``butterfly_all_reduce_mesh``) comes
with the pipeline-engine slice.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.common import tree_map, tree_sub


@dataclasses.dataclass
class OuterState:
    anchor: Any            # params at last sync (the shared model)
    momentum: Any          # outer Nesterov momentum buffer
    outer_step: int


def outer_init(params) -> OuterState:
    """The anchor is ``params`` itself, not a copy: the reference's
    ``jax.tree.map(jnp.asarray, params)`` aliases its arrays too, so the
    swarm keeps one copy of each stage's anchor."""
    return OuterState(
        anchor=params,
        momentum=tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                device=p.device), params),
        outer_step=0,
    )


@torch.no_grad()
def outer_update(state: OuterState, avg_params, *, outer_lr: float = 0.7,
                 outer_momentum: float = 0.9, nesterov: bool = True
                 ) -> OuterState:
    """Nesterov outer step on the averaged worker parameters.

    outer_grad = anchor - avg(workers); anchor <- anchor - lr * step(grad).
    Returns a new state; ``state`` is left as it was."""
    delta = tree_sub(state.anchor, avg_params)           # outer "gradient"

    def upd(m, d, a):
        d = d.to(torch.float32)
        m_new = outer_momentum * m + d
        step = d + outer_momentum * m_new if nesterov else m_new
        return m_new, (a.to(torch.float32) - outer_lr * step).to(a.dtype)

    new_m, new_a = {}, {}

    def walk(m, d, a, out_m, out_a):
        for k in sorted(a):
            if isinstance(a[k], dict):
                out_m[k], out_a[k] = {}, {}
                walk(m[k], d[k], a[k], out_m[k], out_a[k])
            else:
                out_m[k], out_a[k] = upd(m[k], d[k], a[k])

    walk(state.momentum, delta, state.anchor, new_m, new_a)
    return OuterState(new_a, new_m, state.outer_step + 1)


def should_merge(batches_done: dict[int, int], b_min: int,
                 quorum_frac: float = 0.5) -> bool:
    """Paper section 2.1: merge once >= quorum of miners completed B_min
    batches."""
    if not batches_done:
        return False
    qualifying = sum(1 for b in batches_done.values() if b >= b_min)
    return qualifying >= max(1, int(len(batches_done) * quorum_frac))


def effective_batch(batches_done: dict[int, int], b_min: int) -> int:
    """B_eff = sum of B_m over miners with B_m >= B_min (paper section
    2.1)."""
    return sum(b for b in batches_done.values() if b >= b_min)
