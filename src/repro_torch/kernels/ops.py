"""Entry points the models call for the kernels (mirrors ``repro/kernels/
ops.py``).

Dispatch goes by the device of the input tensor and nothing else:

  * a CPU tensor takes the plain PyTorch version (``ref.py``);
  * a CUDA tensor launches the hand-written kernel, or raises if the kernel
    cannot build or launch, or the card is not sm_90.

No ``try`` falls back and no environment variable picks the plain version
on the card.  Kernels not yet ported raise on a CUDA tensor instead of
quietly running the plain version.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import quant_stream as qs
from repro_torch.kernels import ref


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    q_offset: Union[int, torch.Tensor] = 0,
                    kv_len: Optional[torch.Tensor] = None,
                    softmax_scale: Optional[float] = None) -> torch.Tensor:
    """GQA attention.  With ``kv_len`` (the KV-cache path, prefill and
    decode alike) a CUDA tensor goes to the cached-decode kernel K4; the
    no-cache flash kernel K1 is not ported yet."""
    if q.device.type == "cpu":
        return ref.attention(q, k, v, causal=causal, q_offset=q_offset,
                             kv_len=kv_len, softmax_scale=softmax_scale)
    if kv_len is not None and causal:
        return da.decode_attention(q, k, v, q_offset=q_offset, kv_len=kv_len,
                                   softmax_scale=softmax_scale)
    raise NotImplementedError(
        "K1 (the flash-attention kernel, repro/kernels/flash_attention.py) "
        "is not ported yet: attention without a KV cache has no CUDA kernel "
        "in this slice")


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
