"""Plain PyTorch versions of the kernels the port runs.

Mirrors ``repro/kernels/ref.py`` operation for operation, so that on the
same inputs the two packages compute the same numbers: CPU tensors run
these, and every hand-written kernel is held against them on the card.
"""
from __future__ import annotations

import math
from typing import Optional, Union

import torch


def attention(
    q: torch.Tensor,            # (B, Sq, H, D)
    k: torch.Tensor,            # (B, Skv, KH, D)
    v: torch.Tensor,            # (B, Skv, KH, D)
    *,
    causal: bool = True,
    q_offset: Union[int, torch.Tensor] = 0,
    softmax_scale: Optional[float] = None,
    kv_len: Optional[torch.Tensor] = None,   # (B,) valid kv length
) -> torch.Tensor:
    """Grouped-query attention with optional causal and KV-length masks.

    ``q_offset`` is the absolute position of q[:, 0]: an int, a 0-d tensor
    or one per batch element (B,).  Returns (B, Sq, H, D) in q.dtype."""
    B, Sq, H, D = q.shape
    _, Skv, KH, _ = k.shape
    if H % KH:
        raise ValueError(f"query heads {H} not a multiple of kv heads {KH}")
    G = H // KH
    scale = softmax_scale if softmax_scale is not None else 1.0 / math.sqrt(D)

    qf = q.float() * scale
    kf = k.float()
    vf = v.float()
    # (B, KH, G, Sq, D) x (B, KH, Skv, D) -> (B, KH, G, Sq, Skv)
    qf = qf.reshape(B, Sq, KH, G, D).permute(0, 2, 3, 1, 4)
    kf = kf.permute(0, 2, 1, 3)
    vf = vf.permute(0, 2, 1, 3)
    logits = torch.einsum("bkgqd,bksd->bkgqs", qf, kf)

    dev = q.device
    mask = torch.zeros((B, 1, 1, Sq, Skv), dtype=torch.float32, device=dev)
    kpos = torch.arange(Skv, device=dev)
    if causal:
        off = torch.as_tensor(q_offset, device=dev).reshape(-1, 1, 1)
        qpos = torch.arange(Sq, device=dev)[None, :, None] + off  # (B|1,Sq,1)
        causal_mask = torch.where(kpos[None, None, :] <= qpos, 0.0,
                                  float("-inf"))
        mask = mask + causal_mask[:, None, None]
    if kv_len is not None:
        valid = kpos[None, :] < kv_len.to(dev)[:, None]         # (B, Skv)
        mask = mask + torch.where(valid, 0.0, float("-inf"))[
            :, None, None, None, :]
    probs = torch.softmax(logits + mask, dim=-1)
    out = torch.einsum("bkgqs,bksd->bkgqd", probs, vf)
    out = out.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, D)
    return out.to(q.dtype)


def rmsnorm(x: torch.Tensor, gamma: torch.Tensor,
            eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm: the variance reduces in f32, the rsqrt scale and the gain
    apply in x.dtype (``repro/kernels/ref.py:rmsnorm``)."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    scale = torch.rsqrt(var + eps).to(x.dtype)
    return x * scale * gamma.to(x.dtype)


# ---------------------------------------------------------------------------
# int8 blockwise codec
# ---------------------------------------------------------------------------


def quantize_int8(x: torch.Tensor,
                  block: int = 256) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-block int8 quantization of a flat vector.

    Returns (q int8 (n,), scales f32 (n // block,)).  The scale divides, as
    in the reference (no reciprocal multiply), and ``torch.round`` rounds
    half to even like ``jnp.round``, so the codes match bit for bit."""
    (n,) = x.shape
    if n % block:
        raise ValueError(f"block {block} does not divide n={n}")
    xb = x.float().reshape(n // block, block)
    amax = xb.abs().amax(dim=1, keepdim=True)
    # a tensor divisor: PyTorch's CUDA division by a Python scalar
    # multiplies by its rounded reciprocal, one ulp off on some blocks
    scale = torch.where(amax > 0, amax / torch.full_like(amax, 127.0),
                        torch.ones_like(amax))
    q = torch.clamp(torch.round(xb / scale), -127, 127).to(torch.int8)
    return q.reshape(n), scale[:, 0]


def dequantize_int8(q: torch.Tensor, scales: torch.Tensor,
                    block: int = 256) -> torch.Tensor:
    (n,) = q.shape
    qb = q.float().reshape(n // block, block)
    return (qb * scales[:, None]).reshape(n)


def wire_code_block(n: int, last_dim: int) -> int:
    """Quantization block for an n-element wire code: 256 when it divides,
    else one scale per code row (the trailing bottleneck dim divides)."""
    return 256 if n % 256 == 0 else last_dim


def int8_wire_roundtrip(z: torch.Tensor,
                        block: Optional[int] = None) -> torch.Tensor:
    """What the receiving stage sees after quantize -> wire -> dequantize
    of a bottleneck-code tensor."""
    blk = block or wire_code_block(z.numel(), z.shape[-1])
    q, s = quantize_int8(z.float().reshape(-1), block=blk)
    return dequantize_int8(q, s, block=blk).reshape(z.shape).to(z.dtype)


# ---------------------------------------------------------------------------
# Butterfly shard merge (paper section 5.2)
# ---------------------------------------------------------------------------


def shard_merge(shards: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Masked mean over the miner copies of one shard: shards (M, L), valid
    (M,) bool -> (L,) f32, sum_m valid_m * shards[m] / max(sum valid, 1).

    The sum runs over m = 0 .. M-1 in index order, one row at a time, so
    the kernel that sums in the same order equals it bit for bit."""
    vf = valid.to(device=shards.device, dtype=torch.float32)
    num = shards[0].float() * vf[0]
    for m in range(1, shards.shape[0]):
        num = num + shards[m].float() * vf[m]
    den = torch.clamp(vf.sum(), min=1.0)
    return num / den
