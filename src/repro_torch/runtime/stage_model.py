"""Per-stage model functions of the serve plane (mirrors
``repro/runtime/stage_model.py``).

Each stage owns one contiguous layer slice of a dense decoder LM, with
bottleneck codes as the inter-stage wire format:

  first: tokens --embed--> blocks --encode--> z
  mid:   z --decode--> blocks --encode--> z'
  last:  z --decode--> blocks --norm--> logits
  solo:  tokens --embed--> blocks --norm--> logits   (a one-stage swarm)

``StageProgram`` carries the serve entries (``init_cache``, ``prefill``,
``decode_step``, ``encode_wire``, ``decode_wire``); the train entries wait
for the training slice.  Parameters are dicts of tensors with layer-stacked
``blocks``, the JAX package's tree layout, so ``repro_torch.convert`` can
carry a JAX stage's parameters over as they are.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from repro_torch.common import generator, tree_map
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import blocks as blk
from repro_torch.models.layers import (
    KVCache,
    dense_init,
    embed,
    init_kv_cache,
    logits as logits_fn,
    norm_init,
    rmsnorm,
)

WIRE_DTYPE = torch.bfloat16
SERVE_WIRE_CODECS = ("none", "int8")


@dataclasses.dataclass(frozen=True)
class SwarmModelSpec:
    """The model split into ``n_stages`` equal layer slices, one per stage
    (the reference's virtual stages come with the pipeline slice)."""
    cfg: ModelConfig
    n_stages: int
    compress: bool = True
    bottleneck_dim: int = 16

    @property
    def layers_per_stage(self) -> int:
        if self.cfg.n_layers % self.n_stages:
            raise ValueError(f"{self.n_stages} stages do not divide "
                             f"{self.cfg.n_layers} layers")
        return self.cfg.n_layers // self.n_stages

    def role(self, stage: int) -> str:
        if stage == 0:
            return "first"
        return "last" if stage == self.n_stages - 1 else "mid"


def _stack(trees: list) -> dict:
    """Stack a list of equal-structure parameter dicts along a new leading
    (layer) axis."""
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def init_stage_params(gen: torch.Generator, spec: SwarmModelSpec, stage: int,
                      role: Optional[str] = None) -> dict:
    """Stage parameters gated by boundary role, drawn from ``gen`` on its
    device.  ``role`` defaults to the pipeline role; a one-stage program
    passes "solo" (embedding entry and logits exit, no codec)."""
    cfg = spec.cfg
    dev = gen.device
    kind = blk.period_kinds(cfg)[0]
    layers = [blk.init_block(gen, kind, cfg)
              for _ in range(spec.layers_per_stage)]
    p: dict = {"blocks": _stack(layers)}
    del layers
    d, db = cfg.d_model, spec.bottleneck_dim
    role = role if role is not None else spec.role(stage)
    if role in ("first", "solo"):
        p["embeds"] = {"embed": dense_init(gen, cfg.padded_vocab, d,
                                           scale=1.0)}
    if role in ("mid", "last") and spec.compress:
        p["w_up"] = dense_init(gen, db, d, scale=1.0 / math.sqrt(db))
        p["alpha_dec"] = torch.tensor(0.5, dtype=torch.float32, device=dev)
    if role in ("first", "mid") and spec.compress:
        p["enc_norm"] = norm_init(d, dev)
        p["w_down"] = dense_init(gen, d, db)
    if role in ("last", "solo"):
        p["final_norm"] = norm_init(d, dev)
        p["unembed"] = dense_init(gen, cfg.padded_vocab, d)
    return p


def _blocks_apply_cached(p_blocks: dict, x: torch.Tensor, cfg: ModelConfig,
                         cache: KVCache) -> tuple[torch.Tensor, KVCache]:
    """Run the slice over the layer-stacked stage cache.  Positions are
    absolute, offset by the cache length (all layers advance together);
    each layer writes its keys and values into its cache slice in place."""
    kind = blk.period_kinds(cfg)[0]
    B, S = x.shape[0], x.shape[1]
    pos = (cache.length + torch.arange(S, dtype=torch.int32,
                                       device=x.device))[None].expand(B, S)
    ctx = blk.BlockCtx(cfg=cfg, positions=pos)
    for layer in range(cache.k.shape[0]):
        lp = tree_map(lambda t: t[layer], p_blocks)
        st = KVCache(cache.k[layer], cache.v[layer], cache.length)
        x, _, _ = blk.apply_block(kind, lp, x, ctx, st)
    return x, KVCache(cache.k, cache.v, cache.length + S)


def _stage_entry(params: dict, x_in: torch.Tensor, spec: SwarmModelSpec,
                 role: str) -> torch.Tensor:
    """Boundary decode at stage entry: token embedding on the first stage,
    bottleneck decode (w_up in f32, alpha in bf16) elsewhere."""
    cfg = spec.cfg
    if role in ("first", "solo"):
        return embed({"embed": params["embeds"]["embed"]}, x_in, cfg)
    if spec.compress:
        x = (x_in.float() @ params["w_up"].float()).to(torch.bfloat16)
        return params["alpha_dec"].to(torch.bfloat16) * x
    return x_in.to(torch.bfloat16)


def _stage_exit(params: dict, x: torch.Tensor, spec: SwarmModelSpec,
                role: str) -> torch.Tensor:
    """Boundary encode at stage exit: logits on the last stage, bottleneck
    encode (enc_norm, w_down in f32, then the wire dtype) elsewhere."""
    cfg = spec.cfg
    if role in ("last", "solo"):
        x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
        return logits_fn({"embed": params["unembed"]}, x, cfg)
    if spec.compress:
        xn = rmsnorm(x, params["enc_norm"], cfg.norm_eps)
        return (xn.float() @ params["w_down"].float()).to(WIRE_DTYPE)
    return x.to(WIRE_DTYPE)


@torch.no_grad()
def stage_decode_step(params: dict, x_in: torch.Tensor, cache: KVCache,
                      spec: SwarmModelSpec,
                      role: str) -> tuple[torch.Tensor, KVCache]:
    """One serve step of the stage: ``x_in`` is tokens (first stage) or a
    wire code, with S >= 1 (the whole prompt, or one token).  Returns
    (stage output, cache advanced by S)."""
    x = _stage_entry(params, x_in, spec, role)
    x, cache = _blocks_apply_cached(params["blocks"], x, spec.cfg, cache)
    return _stage_exit(params, x, spec, role), cache


def init_stage_cache(spec: SwarmModelSpec, stage: int, batch: int,
                     max_len: int, device: torch.device | str,
                     dtype: torch.dtype = WIRE_DTYPE) -> KVCache:
    """Stage-local KV cache: layer-stacked buffers for this stage's slice."""
    kind = blk.period_kinds(spec.cfg)[0]
    if not kind.startswith("attn"):
        raise ValueError(f"serve plane needs KV-cache block states; got "
                         f"block kind {kind!r}")
    return init_kv_cache(spec.cfg, batch, max_len, device, dtype,
                         n_layers=spec.layers_per_stage)


# ---------------------------------------------------------------------------
# StageProgram: the serve face of one stage
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class StageProgram:
    """One stage's layer slice as a program with named serve entries over
    the same parameters and boundary codecs.  ``encode_wire``/
    ``decode_wire`` apply the optional int8 wire codec to boundary codes,
    so the pipelined driver and the sequential oracle ship identical
    payloads.  Payloads are host (CPU) tensors, as the reference ships
    numpy arrays; ``device`` is where the stage computes."""
    spec: SwarmModelSpec
    stage: int
    wire_codec: str = "none"      # "none" | "int8" (SERVE_WIRE_CODECS)
    device: str = "cuda"

    def __post_init__(self):
        if self.wire_codec not in SERVE_WIRE_CODECS:
            raise ValueError(f"unknown wire codec {self.wire_codec!r}")
        if not 0 <= self.stage < self.spec.n_stages:
            raise ValueError(f"stage {self.stage} out of range")

    @property
    def role(self) -> str:
        if self.spec.n_stages == 1:
            return "solo"
        return self.spec.role(self.stage)

    def init_cache(self, batch: int, max_len: int,
                   dtype: torch.dtype = WIRE_DTYPE) -> KVCache:
        return init_stage_cache(self.spec, self.stage, batch, max_len,
                                self.device, dtype)

    def prefill(self, params: dict, x_in: torch.Tensor, cache: KVCache):
        """Run the whole prompt through the slice into a fresh cache."""
        return stage_decode_step(params, x_in, cache, self.spec, self.role)

    def decode_step(self, params: dict, x_in: torch.Tensor, cache: KVCache):
        """Advance the slice by the rows of ``x_in`` (one token to decode)."""
        return stage_decode_step(params, x_in, cache, self.spec, self.role)

    # ---- boundary wire codec (stage exit -> transport -> next entry) ----
    def encode_wire(self, code: torch.Tensor) -> dict:
        """Host payload of this stage's output: mid-chain codes optionally
        as the int8 (codes, scales) pair, last-stage logits as they are."""
        if self.role in ("last", "solo") or self.wire_codec != "int8":
            return {"code": code.cpu()}
        q, s = ops.wire_encode(code)
        return {"q": q.cpu(), "s": s.cpu()}

    def decode_wire(self, payload: dict) -> torch.Tensor:
        """Inverse of ``encode_wire`` on this stage's device: int8 pairs
        dequantize to exact f32 products (q * scale)."""
        if "code" in payload:
            return payload["code"].to(self.device)
        return ops.wire_decode(payload["q"].to(self.device),
                               payload["s"].to(self.device))


def sample_token(logits: torch.Tensor, *, temperature: float,
                 gen: Optional[torch.Generator] = None) -> torch.Tensor:
    """One sampling decision shared by every serve path: greedy argmax
    (first maximum) at temperature 0, Gumbel-max over ``logits /
    temperature`` with ``gen`` otherwise.  ``logits`` (B, vocab) on the
    host; returns (B,) int32."""
    logits = logits.float().cpu()
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    u = torch.rand(logits.shape, generator=gen, dtype=torch.float32)
    gumbel = -torch.log(-torch.log(u))
    return torch.argmax(logits / temperature + gumbel,
                        dim=-1).to(torch.int32)


def request_key(seed: int, req_id: int, index: int) -> torch.Generator:
    """Deterministic per-(request, token) sampling generator (host):
    identical for the pipelined driver and the sequential oracle."""
    return generator("cpu", "serve-sample", seed, req_id, index)


def serve_stage_params(spec: SwarmModelSpec, seed: int, stage: int,
                       device: torch.device | str = "cuda") -> dict:
    """Stage weights for serving, derived from ``(seed, stage)`` on
    ``device``, so the sequential oracle and the in-process servers hold
    identical parameters without weights crossing a boundary.  A one-stage
    swarm serves the "solo" role."""
    role = "solo" if spec.n_stages == 1 else spec.role(stage)
    return init_stage_params(generator(device, "serve-params", seed, stage),
                             spec, stage, role=role)
