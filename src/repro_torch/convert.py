"""Carry parameters and activations from the JAX package into the port.

The JAX package's stage parameters are a pytree of arrays with
layer-stacked ``blocks``; the port keeps the same tree as dicts of tensors.
A caller turns the JAX tree into numpy arrays (``np.asarray`` on each
leaf) and hands it here, so both packages compute on identical weights.
Nothing here imports jax: bf16 arrives as numpy's ``bfloat16`` extension
dtype and crosses through a 16-bit view.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.common import tree_to
from repro_torch.core import diloco


def tensor_from_numpy(a: Any, device: torch.device | str) -> torch.Tensor:
    """One array (numpy, or anything ``np.asarray`` takes) as a tensor on
    ``device``, bit for bit, bf16 included, 0-d arrays staying 0-d."""
    a = np.array(a, copy=True, order="C")
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def stage_params_from_numpy(tree: dict, device: torch.device | str) -> dict:
    """A JAX stage's parameter tree (dicts of numpy arrays) as the port's
    parameter dict on ``device``."""
    if isinstance(tree, dict):
        return {k: stage_params_from_numpy(v, device) for k, v in tree.items()}
    return tensor_from_numpy(tree, device)


def load_swarm_state(swarm, anchors: list) -> None:
    """Start a port ``Swarm`` from a JAX swarm's anchors: ``anchors[s]`` is
    stage s's parameter tree as numpy arrays (``jax.tree.map(np.asarray,
    jax_swarm.anchors[s])``).  The anchors, the outer states built on them
    (zero momentum) and every miner's parameters (a copy of its stage's
    anchor, with fresh optimizer state) are replaced, as a freshly created
    swarm holds them.  Call it before the first epoch."""
    if swarm.epoch or swarm.global_tick:
        raise ValueError("load_swarm_state needs a swarm that has not run")
    if len(anchors) != len(swarm.anchors):
        raise ValueError(f"{len(anchors)} anchors for "
                         f"{len(swarm.anchors)} stages")
    swarm.anchors = [stage_params_from_numpy(a, swarm.device)
                     for a in anchors]
    swarm.outer = [diloco.outer_init(p) for p in swarm.anchors]
    for m in swarm.miners.values():
        m.params = tree_to(swarm.anchors[m.stage], swarm.device)
        m.opt_state = m.opt.init(m.params)
        m.inner_step = 0
