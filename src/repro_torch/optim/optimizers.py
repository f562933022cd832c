"""Inner optimizer of the swarm's miners: AdamW (mirrors ``adamw`` of
``repro/optim/optimizers.py``; the other optimizers there come with later
slices).

Functional optax-style API, as in the reference:

    opt = adamw(schedule, ...)
    opt_state = opt.init(params)
    new_params, new_opt_state = opt.update(grads, opt_state, params, step)

One difference in placement, none in numbers: JAX arrays are immutable, so
the reference builds new trees; ``update`` here writes the new values into
the tensors of ``params`` and ``opt_state`` and returns those same trees.
A full-width miner holds 9 GB of parameters and moments, and a second copy
for the length of an update would not fit four miners on one card.  No
caller keeps an old tree it expects unchanged (snapshots are copies).
Weight decay applies to every leaf, as in the reference.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from repro_torch.common import tree_leaves, tree_map


class Optimizer(NamedTuple):
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any, int], tuple[Any, Any]]
    name: str


def adamw(schedule, beta1=0.9, beta2=0.95, eps=1e-8, weight_decay=0.1,
          state_dtype=torch.float32) -> Optimizer:
    def init(params):
        def zeros():
            return tree_map(lambda p: torch.zeros(p.shape, dtype=state_dtype,
                                                  device=p.device), params)
        return {"mu": zeros(), "nu": zeros()}

    @torch.no_grad()
    def update(grads, state, params, step: int):
        step = int(step) + 1
        step_f = torch.tensor(float(step), dtype=torch.float32)
        lr_c = schedule(step)
        b1c_c = 1 - torch.pow(torch.tensor(beta1, dtype=torch.float32),
                              step_f)
        b2c_c = 1 - torch.pow(torch.tensor(beta2, dtype=torch.float32),
                              step_f)
        scalars: dict = {}

        def on(dev):
            # the step's f32 scalars as 0-d tensors on the leaf's device: on
            # the card a division by a Python or CPU scalar becomes a
            # multiply by its rounded reciprocal, not an IEEE division
            if dev not in scalars:
                scalars[dev] = (lr_c.to(dev), b1c_c.to(dev), b2c_c.to(dev))
            return scalars[dev]

        for g, mu, nu, p in zip(tree_leaves(grads), tree_leaves(state["mu"]),
                                tree_leaves(state["nu"]),
                                tree_leaves(params)):
            lr, b1c, b2c = on(p.device)
            g = g.to(torch.float32)
            mu_f = beta1 * mu.to(torch.float32) + (1 - beta1) * g
            nu_f = beta2 * nu.to(torch.float32) + (1 - beta2) * torch.square(g)
            step_dir = (mu_f / b1c) / (torch.sqrt(nu_f / b2c) + eps)
            new_p = p - lr * (step_dir + weight_decay * p.to(torch.float32)
                              ).to(p.dtype)
            p.copy_(new_p)
            mu.copy_(mu_f)
            nu.copy_(nu_f)
        return params, state

    return Optimizer(init, update, "adamw")
