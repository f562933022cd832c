"""Wire codecs for the *compressed sharing* stage (paper section 2, stage 2)
(mirrors ``repro/core/compression.py``).

Uniform API over flat f32 vectors:

    payload = encode(vec, codec)        # {"codec", "data", ...meta}
    vec2    = decode(payload, n)        # f32 (n,)
    nbytes  = payload_bytes(payload)    # honest on-wire size

Codecs:
  * "none"  — f32 passthrough (baseline / full-sync stage)
  * "bf16"  — 2x (the paper's activation wire dtype)
  * "int8"  — 4x+ blockwise symmetric, through K2a/K2b on the card; its
              payloads equal the reference's bit for bit
The payload's tensors lie on the vector's device.  ``topk`` and CLASP's
top-k logit reports come with a later slice.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.common import round_up
from repro_torch.kernels import ops

CODECS = ("none", "bf16", "int8", "topk")
INT8_BLOCK = 256


def _unported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} (repro/core/compression.py) is not ported yet: it comes "
        f"with the slice that ports top-k sparsification and CLASP's top-k "
        f"logit reports")


def encode(vec: torch.Tensor, codec: str, topk_frac: float = 1 / 64) -> dict:
    vec = torch.as_tensor(vec).to(torch.float32)
    (n,) = vec.shape
    if codec == "none":
        return {"codec": "none", "data": vec}
    if codec == "bf16":
        return {"codec": "bf16", "data": vec.to(torch.bfloat16)}
    if codec == "int8":
        pad = round_up(n, INT8_BLOCK) - n
        padded = torch.nn.functional.pad(vec, (0, pad)) if pad else vec
        q, scales = ops.quantize_int8(padded.contiguous(), block=INT8_BLOCK)
        return {"codec": "int8", "data": q, "scales": scales, "n": n}
    if codec == "topk":
        raise _unported("the topk codec")
    raise ValueError(f"unknown codec {codec!r}")


def decode(payload: dict, n: int | None = None) -> torch.Tensor:
    codec = payload["codec"]
    if codec == "none":
        return payload["data"]
    if codec == "bf16":
        return payload["data"].to(torch.float32)
    if codec == "int8":
        full = ops.dequantize_int8(payload["data"], payload["scales"],
                                   block=INT8_BLOCK)
        return full[: payload["n"]]
    if codec == "topk":
        raise _unported("the topk codec")
    raise ValueError(f"unknown codec {codec!r}")


def payload_bytes(payload: dict) -> int:
    total = 0
    for v in payload.values():
        if isinstance(v, torch.Tensor):
            total += v.numel() * v.element_size()
        elif isinstance(v, np.ndarray):
            total += v.nbytes
    return total


def topk_logits(logits: torch.Tensor, k: int = 64) -> dict:
    raise _unported("topk_logits")


def loss_from_topk(payload: dict, labels: torch.Tensor):
    raise _unported("loss_from_topk")
