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


def tensor_from_numpy(a: Any, device: torch.device | str) -> torch.Tensor:
    """One array (numpy, or anything ``np.asarray`` takes) as a tensor on
    ``device``, bit for bit, bf16 included."""
    a = np.ascontiguousarray(np.asarray(a))
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a.copy()).to(device)


def stage_params_from_numpy(tree: dict, device: torch.device | str) -> dict:
    """A JAX stage's parameter tree (dicts of numpy arrays) as the port's
    parameter dict on ``device``."""
    if isinstance(tree, dict):
        return {k: stage_params_from_numpy(v, device) for k, v in tree.items()}
    return tensor_from_numpy(tree, device)
