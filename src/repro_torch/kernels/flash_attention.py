"""Flash attention: CUDA kernel K1, its autograd Function and plain version.

Replaces the Pallas TPU kernel ``_flash_kernel`` of
``repro/kernels/flash_attention.py`` (reached there through ``_flash_call``
and ``flash_attention``); the kernel is in ``csrc/flash_attention.cu`` (one
CTA per batch element, kv head and tile of query positions, K/V tiles in
shared memory, online softmax in f32 registers; see the source's note on
what bounds it).  Every attention layer of every training stage forward
reaches it without a KV cache: the miners' forwards, the recomputed forward
of each backward, and the validator's replay.

The backward: the JAX package has no backward kernel.  Its ``custom_vjp``
differentiates the plain formula ``ref.attention``
(``flash_attention.py:123-145``), and ``FlashAttentionFn`` does the same:
its forward launches K1, its backward recomputes ``ref.attention`` under
autograd on the same device and returns that gradient.  That is the
reference's own design, not a fallback; a backward kernel is later work.

``flash_attention`` takes the Function for CUDA tensors and the plain
version for CPU tensors; there is no other switch.  Each kernel launch adds
one to ``LAUNCHES``.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.kernels import _build, ref

LAUNCHES = {"flash_attention": 0}
HEAD_DIMS = (32, 64, 128)
MAX_GROUP = 16

_SIGS = {"flash_attention_bf16": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8
         + [ctypes.c_float, ctypes.c_void_p]}


def _lib() -> ctypes.CDLL:
    return _build.load("flash_attention", _SIGS)


def _scale(D: int, softmax_scale: Optional[float]) -> float:
    return float(softmax_scale if softmax_scale is not None
                 else 1.0 / math.sqrt(D))


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True, q_offset: int = 0,
                         softmax_scale: Optional[float] = None
                         ) -> torch.Tensor:
    """K1 on the card: q (B, Sq, H, D), k/v (B, Skv, KH, D), contiguous
    bf16; ``q_offset`` a static int >= 0.  Forward only."""
    _build.require_hopper(q)
    B, Sq, H, D = q.shape
    if (k.dim() != 4 or k.shape != v.shape or k.shape[0] != B
            or k.shape[3] != D):
        raise ValueError(f"k/v must be (B, Skv, KH, D) matching q "
                         f"{tuple(q.shape)}: {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    Skv, KH = k.shape[1], k.shape[2]
    if D not in HEAD_DIMS or H % KH or H // KH > MAX_GROUP:
        raise ValueError(f"unsupported heads: H={H} KH={KH} D={D} (need "
                         f"D in {HEAD_DIMS}, H % KH == 0, H/KH <= "
                         f"{MAX_GROUP})")
    if not isinstance(q_offset, int) or q_offset < 0:
        raise ValueError(f"q_offset must be a static int >= 0, got "
                         f"{q_offset!r}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if (t.dtype != torch.bfloat16 or not t.is_contiguous()
                or t.device != q.device or t.data_ptr() % 16):
            raise ValueError(f"{name} must be contiguous, 16-byte aligned "
                             f"bf16 on {q.device}")
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        rc = _lib().flash_attention_bf16(
            _build.ptr(q), _build.ptr(k), _build.ptr(v), _build.ptr(out),
            B, Sq, Skv, H, KH, D, int(causal), q_offset,
            _scale(D, softmax_scale), _build.stream_ptr(q))
    _build.check(rc, "flash_attention")
    LAUNCHES["flash_attention"] += 1
    return out


class FlashAttentionFn(torch.autograd.Function):
    """K1 forward; backward = autograd of ``ref.attention`` (the
    reference's ``custom_vjp``)."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, q_offset: int,
                softmax_scale: Optional[float]):
        ctx.save_for_backward(q, k, v)
        ctx.opts = (causal, q_offset, softmax_scale)
        return flash_attention_cuda(q, k, v, causal=causal,
                                    q_offset=q_offset,
                                    softmax_scale=softmax_scale)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        causal, q_offset, softmax_scale = ctx.opts
        with torch.enable_grad():
            qd, kd, vd = (t.detach().requires_grad_() for t in (q, k, v))
            out = ref.attention(qd, kd, vd, causal=causal, q_offset=q_offset,
                                softmax_scale=softmax_scale)
            gq, gk, gv = torch.autograd.grad(out, (qd, kd, vd), g)
        return gq, gk, gv, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, q_offset: int = 0,
                    softmax_scale: Optional[float] = None) -> torch.Tensor:
    """GQA attention of q (B, Sq, H, D) over k/v (B, Skv, KH, D), the row
    q[:, 0] at absolute position ``q_offset``.  Matches ``ref.attention``
    without ``kv_len``; differentiable on both devices."""
    if q.device.type == "cpu":
        return ref.attention(q, k, v, causal=causal, q_offset=q_offset,
                             softmax_scale=softmax_scale)
    return FlashAttentionFn.apply(q, k, v, causal, int(q_offset),
                                  softmax_scale)
