"""Shared utilities the port needs from ``repro/common.py``.

A copy, not an import: ``repro.common`` imports jax.
"""
from __future__ import annotations

import hashlib
from typing import Any, Callable

import torch


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def round_up(x: int, m: int) -> int:
    return cdiv(x, m) * m


def tree_map(fn: Callable[[Any], Any], tree: Any) -> Any:
    """Apply ``fn`` to every leaf of a nest of dicts (the port's parameter
    trees: the JAX package's pytrees of arrays become dicts of tensors)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def stable_hash(*parts: Any) -> int:
    """Deterministic 63-bit hash of a sequence of printable parts (the
    reference's ``stable_hash``): seeds the port's ``torch.Generator``s."""
    h = hashlib.blake2b("\x1f".join(str(p) for p in parts).encode(),
                        digest_size=8)
    return int.from_bytes(h.digest(), "little") & 0x7FFFFFFFFFFFFFFF


def generator(device: torch.device | str, *parts: Any) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded from ``parts``."""
    return torch.Generator(device=device).manual_seed(stable_hash(*parts))


def use_full_f32_matmul() -> None:
    """f32 products on the card run in full f32, as on the CPU and in the
    reference: no TF32 for matmuls or cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
