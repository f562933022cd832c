"""Shared utilities the port needs from ``repro/common.py``.

A copy, not an import: ``repro.common`` imports jax.  Parameter trees are
nests of dicts of tensors; every helper walks them in the reference's
pytree order (dict keys sorted), so ``ravel`` lays out one flat vector
exactly as ``jax.flatten_util.ravel_pytree`` does.
"""
from __future__ import annotations

import hashlib
from typing import Any, Callable, Iterator

import torch


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def round_up(x: int, m: int) -> int:
    return cdiv(x, m) * m


def tree_map(fn: Callable[[Any], Any], tree: Any) -> Any:
    """Apply ``fn`` to every leaf of a nest of dicts (the port's parameter
    trees: the JAX package's pytrees of arrays become dicts of tensors),
    leaf by leaf in ``tree_leaves`` order."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k]) for k in sorted(tree)}
    return fn(tree)


def tree_leaves(tree: Any) -> Iterator[Any]:
    """Leaves in ``jax.tree_util`` order: dict values by sorted key."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_leaves(tree[k])
    else:
        yield tree


def tree_sub(a: Any, b: Any) -> Any:
    """a - b, leaf by leaf, over two trees of the same structure."""
    if isinstance(a, dict):
        return {k: tree_sub(a[k], b[k]) for k in sorted(a)}
    return a - b


def tree_to(tree: Any, device: torch.device | str) -> Any:
    """A copy of ``tree`` on ``device`` (a fresh copy even where the leaf
    already lies there)."""
    return tree_map(lambda x: x.to(device, copy=True), tree)


def unravel_like(tree: Any, vec: torch.Tensor) -> Any:
    """Cut a flat vector into a tree shaped like ``tree``, in
    ``ravel_pytree``'s layout; the pieces are views of ``vec``."""
    leaves = list(tree_leaves(tree))
    pieces = iter(vec.split([x.numel() for x in leaves]))
    return tree_map(lambda x: next(pieces).view(x.shape), tree)


def ravel(tree: Any) -> tuple[torch.Tensor, Callable[[torch.Tensor], Any]]:
    """One flat f32 vector of every leaf, in ``ravel_pytree``'s layout
    (sorted dict keys, each leaf in C order), and the inverse that cuts a
    vector back into a tree of f32 leaves shaped like ``tree``'s."""
    vec = torch.cat([x.to(torch.float32).reshape(-1)
                     for x in tree_leaves(tree)])
    return vec, lambda v: unravel_like(tree, v)


def cosine_similarity(a: torch.Tensor, b: torch.Tensor,
                      eps: float = 1e-8) -> torch.Tensor:
    """Cosine similarity of two flattened tensors, in f32 (the validator's
    agreement metric, paper section 2.3).  Two (near-)zero tensors agree by
    convention."""
    a = a.reshape(-1).float()
    b = b.reshape(-1).float()
    na = torch.linalg.norm(a)
    nb = torch.linalg.norm(b)
    cos = torch.dot(a, b) / torch.clamp(na * nb, min=eps)
    both_zero = (na < 1e-6) & (nb < 1e-6)
    return torch.where(both_zero, torch.ones_like(cos), cos)


def stable_hash(*parts: Any) -> int:
    """Deterministic 63-bit hash of a sequence of printable parts (the
    reference's ``stable_hash``): seeds the port's ``torch.Generator``s."""
    h = hashlib.blake2b("\x1f".join(str(p) for p in parts).encode(),
                        digest_size=8)
    return int.from_bytes(h.digest(), "little") & 0x7FFFFFFFFFFFFFFF


def generator(device: torch.device | str, *parts: Any) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded from ``parts``."""
    return torch.Generator(device=device).manual_seed(stable_hash(*parts))


def resolve_device(device: str) -> str:
    """Check that ``device`` is usable and, for the card, make f32 products
    run in full f32, as on the CPU and in the reference (no TF32 for
    matmuls or cuDNN).  A CUDA device without a card raises: nothing falls
    back to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {device!r} requested but no CUDA device is present "
                f"(pass device='cpu' to run on the host)")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}")
    return str(dev)
