"""Masked shard mean: CUDA kernel K3 and its plain version.

Replaces the Pallas TPU kernel ``_merge_kernel`` of
``repro/kernels/shard_merge.py``; the kernel is in ``csrc/shard_merge.cu``
(one thread per four columns, the sum over miners in index order; bound by
device-memory bytes, see the source's note).  Every butterfly reduce of the
training epoch reaches it (``core/butterfly.py`` ``reduce_shards`` and
``reduce_with_copies``), on the uploads of one layer's qualifying miners.

``shard_merge`` takes the kernel for a CUDA tensor and the plain version
(``ref.shard_merge``) for a CPU tensor; there is no other switch.  The two
agree bit for bit.  Each kernel launch adds one to ``LAUNCHES``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, ref

LAUNCHES = {"shard_merge": 0}
MAX_MINERS = 1024

_SIGS = {"shard_merge_f32": [ctypes.c_void_p] * 3
         + [ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
            ctypes.c_void_p]}


def _lib() -> ctypes.CDLL:
    return _build.load("shard_merge", _SIGS)


def shard_merge_cuda(shards: torch.Tensor, valid: torch.Tensor
                     ) -> torch.Tensor:
    """K3 on the card.  shards (M, L) f32 whose rows are contiguous (a
    column slice of a wider matrix is taken in place), valid (M,) bool or
    0/1 on the same device; returns (L,) f32 (an empty shard launches
    nothing)."""
    _build.require_hopper(shards)
    if shards.dim() == 2 and shards.shape[1] == 0:
        return torch.empty(0, dtype=torch.float32, device=shards.device)
    if (shards.dtype != torch.float32 or shards.dim() != 2
            or shards.stride(1) != 1):
        raise ValueError(f"shards must be (M, L) f32 with contiguous rows, "
                         f"got {shards.dtype} {tuple(shards.shape)} strides "
                         f"{shards.stride()}")
    M, L = shards.shape
    if not 1 <= M <= MAX_MINERS or valid.shape != (M,) \
            or valid.device != shards.device:
        raise ValueError(f"valid must be ({M},) on {shards.device}, with "
                         f"1 <= M <= {MAX_MINERS}; got {tuple(valid.shape)} "
                         f"on {valid.device}")
    ld = shards.stride(0) if M > 1 else L
    vf = valid.to(torch.float32).contiguous()
    out = torch.empty(L, dtype=torch.float32, device=shards.device)
    vec = int(shards.data_ptr() % 16 == 0 and ld % 4 == 0)
    with torch.cuda.device(shards.device):
        rc = _lib().shard_merge_f32(_build.ptr(shards), _build.ptr(vf),
                                    _build.ptr(out), M, L, ld, vec,
                                    _build.stream_ptr(shards))
    _build.check(rc, "shard_merge")
    LAUNCHES["shard_merge"] += 1
    return out


def shard_merge(shards: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """sum_m valid_m * shards[m] / max(sum valid, 1) over the miner axis."""
    if shards.device.type == "cpu":
        return ref.shard_merge(shards, valid)
    return shard_merge_cuda(shards, valid)
