"""Blockwise int8 codec: CUDA kernels K2a/K2b and the wire helpers.

Replaces the Pallas TPU kernels ``_quant_kernel`` and ``_dequant_kernel`` of
``repro/kernels/quant_stream.py``; the kernels are in ``csrc/quant_stream.cu``
(one warp per quantization block; bound by device-memory bytes, see the
source's note).  On the serve plane they code the bottleneck wire at every
stage boundary (``wire_codec="int8"``): block 256 when it divides the code's
element count (prefill), else one scale per code row (16 on a decode step).

``quantize_int8``/``dequantize_int8`` take the kernel for a CUDA tensor and
the plain version (``ref.py``) for a CPU tensor; there is no other switch.
Each kernel launch adds one to ``LAUNCHES``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, ref

BLOCK = 256
MAX_BLOCK = 1024
LAUNCHES = {"quantize_int8": 0, "dequantize_int8": 0}

_SIGS = {
    "quantize_int8": [ctypes.c_void_p] * 3
    + [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p],
    "dequantize_int8": [ctypes.c_void_p] * 3
    + [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p],
}


def _lib() -> ctypes.CDLL:
    return _build.load("quant_stream", _SIGS)


def _check_block(n: int, block: int) -> None:
    if not 0 < block <= MAX_BLOCK or n <= 0 or n % block:
        raise ValueError(f"block {block} must divide n={n} and be in "
                         f"(0, {MAX_BLOCK}]")


def quantize_int8_cuda(x: torch.Tensor,
                       block: int = BLOCK) -> tuple[torch.Tensor, torch.Tensor]:
    """K2a on the card: flat contiguous f32 (n,) -> (int8 (n,), f32 scales)."""
    _build.require_hopper(x)
    if x.dtype != torch.float32 or x.dim() != 1 or not x.is_contiguous():
        raise ValueError(f"quantize_int8 takes a contiguous 1-d f32 tensor, "
                         f"got {x.dtype} {tuple(x.shape)}")
    n = x.numel()
    _check_block(n, block)
    q = torch.empty(n, dtype=torch.int8, device=x.device)
    s = torch.empty(n // block, dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        rc = _lib().quantize_int8(_build.ptr(x), _build.ptr(q),
                                  _build.ptr(s), n, block,
                                  _build.stream_ptr(x))
    _build.check(rc, "quantize_int8")
    LAUNCHES["quantize_int8"] += 1
    return q, s


def dequantize_int8_cuda(q: torch.Tensor, scales: torch.Tensor,
                         block: int = BLOCK) -> torch.Tensor:
    """K2b on the card: q * scale in f32."""
    _build.require_hopper(q)
    n = q.numel()
    _check_block(n, block)
    if (q.dtype != torch.int8 or q.dim() != 1 or not q.is_contiguous()
            or scales.dtype != torch.float32 or scales.dim() != 1
            or scales.numel() != n // block or not scales.is_contiguous()
            or scales.device != q.device):
        raise ValueError(
            f"dequantize_int8 takes contiguous int8 (n,) and f32 (n/block,) "
            f"on one device, got {q.dtype} {tuple(q.shape)}, "
            f"{scales.dtype} {tuple(scales.shape)} on {scales.device}")
    out = torch.empty(n, dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        rc = _lib().dequantize_int8(_build.ptr(q), _build.ptr(scales),
                                    _build.ptr(out), n, block,
                                    _build.stream_ptr(q))
    _build.check(rc, "dequantize_int8")
    LAUNCHES["dequantize_int8"] += 1
    return out


def quantize_int8(x: torch.Tensor,
                  block: int = BLOCK) -> tuple[torch.Tensor, torch.Tensor]:
    if x.device.type == "cpu":
        return ref.quantize_int8(x, block=block)
    return quantize_int8_cuda(x, block)


def dequantize_int8(q: torch.Tensor, scales: torch.Tensor,
                    block: int = BLOCK) -> torch.Tensor:
    if q.device.type == "cpu":
        return ref.dequantize_int8(q, scales, block=block)
    return dequantize_int8_cuda(q, scales, block)


# ---------------------------------------------------------------------------
# int8 pipeline wire codec
# ---------------------------------------------------------------------------


def wire_block(n: int, last_dim: int) -> int:
    """Block size for an n-element code tensor (mirrors
    ``ref.wire_code_block``)."""
    return BLOCK if n % BLOCK == 0 else last_dim


def quantize_wire(z: torch.Tensor):
    """(..., d_b) code tensor -> (q int8 same shape, scales f32, block)."""
    blk = wire_block(z.numel(), z.shape[-1])
    q, s = quantize_int8(z.float().reshape(-1).contiguous(), block=blk)
    return q.reshape(z.shape), s, blk


def dequantize_wire(q: torch.Tensor, scales: torch.Tensor,
                    block: int) -> torch.Tensor:
    return dequantize_int8(q.reshape(-1).contiguous(), scales,
                           block=block).reshape(q.shape)


def wire_nbytes(shape, block: int | None = None) -> int:
    """On-wire bytes of an int8-coded tensor: the int8 payload plus one f32
    scale per block."""
    n = 1
    for dim in shape:
        n *= dim
    blk = block or wire_block(n, shape[-1])
    return n + (n // blk) * 4
