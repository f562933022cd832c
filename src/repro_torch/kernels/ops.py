"""Entry points the models call for the kernels (mirrors ``repro/kernels/
ops.py``).

Dispatch goes by the device of the input tensor and nothing else:

  * a CPU tensor takes the plain PyTorch version (``ref.py``);
  * a CUDA tensor launches the hand-written kernel, or raises if the kernel
    cannot build or launch, or the card is not sm_90.

No ``try`` falls back and no environment variable picks the plain version
on the card.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import quant_stream as qs
from repro_torch.kernels import ref
from repro_torch.kernels import shard_merge as smk


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    q_offset: Union[int, torch.Tensor] = 0,
                    kv_len: Optional[torch.Tensor] = None,
                    softmax_scale: Optional[float] = None) -> torch.Tensor:
    """GQA attention.  On a CUDA tensor: with ``kv_len`` (the KV-cache
    path, prefill and decode alike) the cached-decode kernel K4; without it
    the flash kernel K1 (``q_offset`` a static int), whose backward is
    autograd of the plain version, as in the reference."""
    if q.device.type == "cpu":
        return ref.attention(q, k, v, causal=causal, q_offset=q_offset,
                             kv_len=kv_len, softmax_scale=softmax_scale)
    if kv_len is None:
        return fa.flash_attention(q, k, v, causal=causal, q_offset=q_offset,
                                  softmax_scale=softmax_scale)
    if not causal:
        raise ValueError("cached attention (kv_len) is causal only, as in "
                         "the reference")
    return da.decode_attention(q, k, v, q_offset=q_offset, kv_len=kv_len,
                               softmax_scale=softmax_scale)


def wire_encode(z: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Quantize a wire code into the shipped (int8 codes, f32 scales) pair;
    ``wire_decode(*wire_encode(z))`` equals ``ref.int8_wire_roundtrip(z)``
    in f32."""
    q, s, _ = qs.quantize_wire(z)
    return q, s


def wire_decode(q: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """Exact f32 dequantization of a ``wire_encode`` pair (q * scale)."""
    return qs.dequantize_wire(q, scales, qs.wire_block(q.numel(),
                                                       q.shape[-1]))


def quantize_int8(x: torch.Tensor,
                  block: int = 256) -> tuple[torch.Tensor, torch.Tensor]:
    """Blockwise int8 codes and f32 scales of a flat f32 vector (K2a on
    the card)."""
    return qs.quantize_int8(x, block=block)


def dequantize_int8(q: torch.Tensor, scales: torch.Tensor,
                    block: int = 256) -> torch.Tensor:
    """q * scale in f32 (K2b on the card)."""
    return qs.dequantize_int8(q, scales, block=block)


def shard_merge(shards: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Masked shard mean, the butterfly reduce's inner loop (K3 on the
    card)."""
    return smk.shard_merge(shards, valid)
