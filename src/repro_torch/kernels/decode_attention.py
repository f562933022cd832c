"""Cached-decode GQA attention: CUDA kernel K4 and its plain version.

Replaces the Pallas TPU kernel ``_decode_kernel`` of
``repro/kernels/decode_attention.py``; the kernel is in
``csrc/decode_attention.cu`` (one CTA per batch element, kv head and tile
of query positions, K/V tiles in shared memory, online softmax in f32
registers; see the source's note on what bounds it).  Every attention layer
of every serve stage reaches it, for the prompt (Sq = prompt length) and
for each decoded token (Sq = 1).

``decode_attention`` takes the kernel for CUDA tensors and the plain
version (``ref.attention`` with ``causal=True``) for CPU tensors; there is
no other switch.  Each kernel launch adds one to ``LAUNCHES``.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional, Union

import torch

from repro_torch.kernels import _build, ref

LAUNCHES = {"decode_attention": 0}
HEAD_DIMS = (32, 64, 128)
MAX_GROUP = 16

_SIGS = {"decode_attention_bf16": [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
         + [ctypes.c_float, ctypes.c_void_p]}


def _lib() -> ctypes.CDLL:
    return _build.load("decode_attention", _SIGS)


def _per_batch(x: Union[int, torch.Tensor], B: int,
               device: torch.device) -> torch.Tensor:
    """A scalar or (B,) length/offset as a contiguous (B,) int32 tensor."""
    t = torch.as_tensor(x, dtype=torch.int32, device=device)
    return t.expand(B).contiguous() if t.dim() == 0 else t.contiguous()


def decode_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, q_offset: torch.Tensor, kv_len: torch.Tensor,
                          softmax_scale: Optional[float] = None
                          ) -> torch.Tensor:
    """K4 on the card.  q (B, Sq, H, D), k/v (B, S_max, KH, D), all
    contiguous bf16; q_offset and kv_len (B,) int32 on the same device."""
    _build.require_hopper(q)
    B, Sq, H, D = q.shape
    if (k.dim() != 4 or k.shape != v.shape or k.shape[0] != B
            or k.shape[3] != D):
        raise ValueError(f"k/v must be (B, S_max, KH, D) matching q "
                         f"{tuple(q.shape)}: {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    S_max, KH = k.shape[1], k.shape[2]
    if D not in HEAD_DIMS or H % KH or H // KH > MAX_GROUP:
        raise ValueError(f"unsupported heads: H={H} KH={KH} D={D} (need "
                         f"D in {HEAD_DIMS}, H % KH == 0, H/KH <= "
                         f"{MAX_GROUP})")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if (t.dtype != torch.bfloat16 or not t.is_contiguous()
                or t.device != q.device or t.data_ptr() % 16):
            raise ValueError(f"{name} must be contiguous, 16-byte aligned "
                             f"bf16 on {q.device}")
    for name, t in (("q_offset", q_offset), ("kv_len", kv_len)):
        if (t.dtype != torch.int32 or t.shape != (B,)
                or not t.is_contiguous() or t.device != q.device):
            raise ValueError(f"{name} must be contiguous (B,) int32 on "
                             f"{q.device}")
    scale = float(softmax_scale if softmax_scale is not None
                  else 1.0 / math.sqrt(D))
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        rc = _lib().decode_attention_bf16(
            _build.ptr(q), _build.ptr(k), _build.ptr(v), _build.ptr(kv_len),
            _build.ptr(q_offset), _build.ptr(out), B, Sq, H, KH, D, S_max,
            scale, _build.stream_ptr(q))
    _build.check(rc, "decode_attention")
    LAUNCHES["decode_attention"] += 1
    return out


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                     q_offset: Union[int, torch.Tensor],
                     kv_len: Union[int, torch.Tensor],
                     softmax_scale: Optional[float] = None) -> torch.Tensor:
    """GQA attention of q (B, Sq, H, D) over a KV buffer (B, S_max, KH, D)
    with valid length ``kv_len`` and absolute first-row position
    ``q_offset`` (each a scalar or (B,)).  Matches ``ref.attention(...,
    causal=True, q_offset=..., kv_len=...)``."""
    B = q.shape[0]
    if q.device.type == "cpu":
        return ref.attention(q, k, v, causal=True,
                             q_offset=_per_batch(q_offset, B, q.device),
                             kv_len=_per_batch(kv_len, B, q.device),
                             softmax_scale=softmax_scale)
    return decode_attention_cuda(
        q, k, v, q_offset=_per_batch(q_offset, B, q.device),
        kv_len=_per_batch(kv_len, B, q.device), softmax_scale=softmax_scale)
