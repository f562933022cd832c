"""Core layers: RMSNorm, RoPE, GQA attention with a KV cache, SwiGLU,
embeddings (mirrors ``repro/models/layers.py``).

Plain functions over parameter dicts of tensors.  The dtype sequence is the
reference's: weights are f32 and cast to the activation dtype (bf16) at
each product, RMSNorm reduces in f32, RoPE angles are f32 and applied in
the activation dtype, logits are f32 against the f32 table.  No mesh
sharding: the port runs one stage per device.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops, ref

Params = dict


# ---------------------------------------------------------------------------
# Init helpers
# ---------------------------------------------------------------------------


def dense_init(gen: torch.Generator, d_in: int, d_out: int,
               scale: Optional[float] = None,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Standard normal truncated to [-2, 2], times ``scale`` (default
    1/sqrt(d_in)), drawn from ``gen`` on the generator's device."""
    scale = scale if scale is not None else 1.0 / math.sqrt(d_in)
    w = torch.empty((d_in, d_out), dtype=torch.float32, device=gen.device)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return w.mul_(scale).to(dtype)


def norm_init(d: int, device: torch.device | str,
              dtype: torch.dtype = torch.float32) -> torch.Tensor:
    return torch.ones((d,), dtype=dtype, device=device)


# ---------------------------------------------------------------------------
# RMSNorm and rotary position embeddings (split-half convention)
# ---------------------------------------------------------------------------


def rmsnorm(x: torch.Tensor, gamma: torch.Tensor,
            eps: float = 1e-5) -> torch.Tensor:
    return ref.rmsnorm(x, gamma, eps)


def rope_angles(positions: torch.Tensor, d_head: int,
                theta: float) -> tuple[torch.Tensor, torch.Tensor]:
    """positions (..., S) int -> cos/sin (..., S, d_head // 2) f32."""
    half = d_head // 2
    exps = torch.arange(0, half, dtype=torch.float32,
                        device=positions.device) / half
    inv_freq = 1.0 / (theta ** exps)
    ang = positions.float()[..., None] * inv_freq
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x (B, S, H, D); cos/sin (B, S, D/2) or (S, D/2), cast to x.dtype
    before the rotation, as in the reference."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    if cos.dim() == 2:
        cos, sin = cos[None], sin[None]
    cos = cos[:, :, None, :].to(x.dtype)
    sin = sin[:, :, None, :].to(x.dtype)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


# ---------------------------------------------------------------------------
# GQA attention
# ---------------------------------------------------------------------------


class KVCache(NamedTuple):
    """KV buffers and the valid prefix length.  ``length`` is a host int:
    every layer of a stage advances in lockstep, so one count serves the
    whole (layer-stacked) stage cache."""
    k: torch.Tensor          # ([L,] B, S_max, KH, D)
    v: torch.Tensor
    length: int


def init_attention(gen: torch.Generator, cfg: ModelConfig) -> Params:
    hd = cfg.head_dim
    p = {
        "wq": dense_init(gen, cfg.d_model, cfg.n_heads * hd),
        "wk": dense_init(gen, cfg.d_model, cfg.n_kv_heads * hd),
        "wv": dense_init(gen, cfg.d_model, cfg.n_kv_heads * hd),
        "wo": dense_init(gen, cfg.n_heads * hd, cfg.d_model,
                         scale=1.0 / math.sqrt(cfg.n_heads * hd * 2
                                               * cfg.n_layers)),
    }
    if cfg.qk_norm:
        p["q_norm"] = norm_init(hd, gen.device)
        p["k_norm"] = norm_init(hd, gen.device)
    return p


def attention(params: Params, x: torch.Tensor, cfg: ModelConfig,
              positions: torch.Tensor, cache: Optional[KVCache] = None,
              causal: bool = True) -> tuple[torch.Tensor, Optional[KVCache]]:
    """x (B, S, d_model) in the compute dtype; positions (B, S) absolute.

    With a cache, the new keys and values are written into the cache
    buffers **in place** at ``min(length, S_max - S)`` (the reference's
    clamped ``dynamic_update_slice``), and the returned cache shares those
    buffers with a length advanced by S."""
    B, S, _ = x.shape
    hd = cfg.head_dim
    dtype = x.dtype

    q = (x @ params["wq"].to(dtype)).reshape(B, S, cfg.n_heads, hd)
    k = (x @ params["wk"].to(dtype)).reshape(B, S, cfg.n_kv_heads, hd)
    v = (x @ params["wv"].to(dtype)).reshape(B, S, cfg.n_kv_heads, hd)
    if cfg.qk_norm:
        q = rmsnorm(q, params["q_norm"], cfg.norm_eps)
        k = rmsnorm(k, params["k_norm"], cfg.norm_eps)
    cos, sin = rope_angles(positions, hd, cfg.rope_theta)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)

    new_cache = None
    if cache is None:
        out = ops.flash_attention(q, k, v, causal=causal)
    else:
        S_max = cache.k.shape[1]
        pos = min(cache.length, S_max - S)
        cache.k[:, pos:pos + S] = k
        cache.v[:, pos:pos + S] = v
        kv_len = torch.full((B,), min(cache.length + S, S_max),
                            dtype=torch.int32, device=x.device)
        q_offset = torch.full((B,), pos, dtype=torch.int32, device=x.device)
        out = ops.flash_attention(q, cache.k, cache.v, causal=True,
                                  q_offset=q_offset, kv_len=kv_len)
        new_cache = KVCache(cache.k, cache.v, cache.length + S)

    out = out.reshape(B, S, cfg.n_heads * hd)
    return out @ params["wo"].to(dtype), new_cache


def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int,
                  device: torch.device | str,
                  dtype: torch.dtype = torch.bfloat16,
                  n_layers: Optional[int] = None) -> KVCache:
    """Layer-stacked KV cache (layers leading), zero-filled."""
    n_layers = cfg.n_layers if n_layers is None else n_layers
    shape = (n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return KVCache(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device), 0)


# ---------------------------------------------------------------------------
# SwiGLU MLP
# ---------------------------------------------------------------------------


def init_mlp(gen: torch.Generator, cfg: ModelConfig,
             d_ff: Optional[int] = None) -> Params:
    d_ff = d_ff or cfg.d_ff
    return {
        "w_gate": dense_init(gen, cfg.d_model, d_ff),
        "w_up": dense_init(gen, cfg.d_model, d_ff),
        "w_out": dense_init(gen, d_ff, cfg.d_model,
                            scale=1.0 / math.sqrt(d_ff * 2 * cfg.n_layers)),
    }


def mlp(params: Params, x: torch.Tensor) -> torch.Tensor:
    dtype = x.dtype
    g = x @ params["w_gate"].to(dtype)
    h = (g * torch.sigmoid(g)) * (x @ params["w_up"].to(dtype))
    return h @ params["w_out"].to(dtype)


# ---------------------------------------------------------------------------
# Embedding / unembedding with Megatron-style vocab padding
# ---------------------------------------------------------------------------


def init_embeddings(gen: torch.Generator, cfg: ModelConfig) -> Params:
    p = {"embed": dense_init(gen, cfg.padded_vocab, cfg.d_model, scale=1.0)}
    if not cfg.tie_embeddings:
        p["unembed"] = dense_init(gen, cfg.padded_vocab, cfg.d_model)
    return p


def embed(params: Params, tokens: torch.Tensor, cfg: ModelConfig,
          dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Gather rows of the f32 table, then cast."""
    return params["embed"][tokens.long()].to(dtype)


def logits(params: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """(B, S, d_model) -> (B, S, padded_vocab) f32; padded entries -1e9."""
    table = params.get("unembed", params["embed"])
    out = x.float() @ table.float().T
    pad = (torch.arange(cfg.padded_vocab, device=x.device)
           >= cfg.vocab_size).float() * -1e9
    return out + pad
