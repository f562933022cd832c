"""Block abstraction (mirrors ``repro/models/blocks.py``), dense kind only.

The serve slice runs the ``attn_dense`` kind: pre-norm GQA attention plus
a SwiGLU FFN, the block of the dense decoder LMs.  The other kinds of the
reference raise ``NotImplementedError`` naming the slice that brings them.

Protocol, as in the reference:
  init_block(gen, kind, cfg)                          -> params
  apply_block(kind, params, x, ctx, state)            -> (y, new_state, aux)
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import (
    KVCache,
    attention,
    init_attention,
    init_mlp,
    mlp,
    norm_init,
    rmsnorm,
)

DENSE = "attn_dense"


@dataclasses.dataclass
class BlockCtx:
    cfg: ModelConfig
    positions: torch.Tensor                # (B, S) absolute positions
    causal: bool = True


def _unported(kind: str) -> NotImplementedError:
    later = ("the jamba hybrid slice" if kind.startswith("mamba")
             else "the model-zoo slice")
    return NotImplementedError(
        f"block kind {kind!r} is not ported yet ({later}); the serve slice "
        f"runs {DENSE!r} only")


def init_block(gen: torch.Generator, kind: str, cfg: ModelConfig) -> dict:
    if kind != DENSE:
        raise _unported(kind)
    d = cfg.d_model
    return {"attn_norm": norm_init(d, gen.device),
            "attn": init_attention(gen, cfg),
            "ffn_norm": norm_init(d, gen.device),
            "mlp": init_mlp(gen, cfg)}


def init_block_state(kind: str, cfg: ModelConfig, batch: int, max_len: int,
                     device: torch.device | str,
                     dtype: torch.dtype = torch.bfloat16) -> KVCache:
    """Decode-time state of one block: its KV cache."""
    if kind != DENSE:
        raise _unported(kind)
    shape = (batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return KVCache(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device), 0)


def apply_block(kind: str, params: dict, x: torch.Tensor, ctx: BlockCtx,
                state: Optional[KVCache] = None
                ) -> tuple[torch.Tensor, Any, float]:
    if kind != DENSE:
        raise _unported(kind)
    cfg = ctx.cfg
    a, new_state = attention(
        params["attn"], rmsnorm(x, params["attn_norm"], cfg.norm_eps), cfg,
        ctx.positions, cache=state, causal=ctx.causal)
    x = x + a
    x = x + mlp(params["mlp"], rmsnorm(x, params["ffn_norm"], cfg.norm_eps))
    return x, new_state, 0.0      # aux loss: none without MoE


def period_kinds(cfg: ModelConfig, decoder: bool = False) -> list[str]:
    """The repeating unit of block kinds for this arch (a copy of the
    reference's layout rule; only ``attn_dense`` can be applied here)."""
    fam = cfg.family
    if fam == "ssm":
        return ["mlstm", "slstm"]
    if fam == "hybrid":
        period = []
        for i in range(cfg.hybrid_period):
            mixer = "attn" if i == cfg.hybrid_attn_index else "mamba"
            if cfg.moe is not None and cfg.moe.layer_pattern == "alternate":
                ffn = "moe" if i % 2 == 1 else "dense"
            else:
                ffn = "moe" if cfg.moe is not None else "dense"
            period.append(f"{mixer}_{ffn}")
        return period
    if cfg.is_encoder_decoder and decoder:
        return ["attn_dense_cross"]
    if cfg.moe is not None:
        if cfg.moe.layer_pattern == "alternate":
            return ["attn_dense", "attn_moe"]
        return ["attn_moe"]
    return [DENSE]
