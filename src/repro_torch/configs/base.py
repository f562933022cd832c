"""Config system: model / compression / parallelism / train / shape configs.

A copy of ``repro.configs.base`` (pure dataclasses) for the PyTorch port,
which imports nothing of the JAX package.  Every assigned architecture gets
one ``src/repro_torch/configs/<id>.py`` exporting
``CONFIG: ArchConfig``.  ``registry.get("qwen3-14b")`` resolves them, and
``--arch`` flags on the launchers go through the registry.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Any, Optional, Sequence

from repro_torch.common import round_up

# ---------------------------------------------------------------------------
# Model family tags (assignment families)
# ---------------------------------------------------------------------------
DENSE = "dense"
MOE = "moe"
SSM = "ssm"
VLM = "vlm"
AUDIO = "audio"
HYBRID = "hybrid"

FAMILIES = (DENSE, MOE, SSM, VLM, AUDIO, HYBRID)


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    # Capacity factor for the padded per-device expert buffers in the EP path.
    capacity_factor: float = 1.25
    # Which layers carry an MoE FFN.  "all" | "alternate" (jamba-style: odd
    # layers MoE, even dense).
    layer_pattern: str = "all"
    router_jitter: float = 0.0
    # FSDP expert gathers ride int8 with per-row scales + straight-through
    # backward (§Perf cell A iteration 2 — halves the dominant collective
    # term of trillion-param MoE training; beyond-paper, in the spirit of
    # the paper's compressed-sharing stage)
    int8_fsdp_gather: bool = False


@dataclasses.dataclass(frozen=True)
class BottleneckConfig:
    """Paper §4: bottleneck transformer blocks with uninterrupted residual flow.

    ``n_bottlenecks`` bottleneck/post-bottleneck pairs are inserted at equally
    spaced block boundaries.  ``bottleneck_dim`` is the compressed activation
    width streamed across the boundary (32 → 64x dim reduction on a 2048-d
    model; with bf16-on-wire that is the paper's 128x vs fp32).
    ``residual_alpha`` is the learned-initialisation weight of the partial
    residual fed into/out of the bottleneck hidden (Fig 4).
    """
    n_bottlenecks: int = 0
    bottleneck_dim: int = 32
    residual_alpha: float = 0.5

    @property
    def enabled(self) -> bool:
        return self.n_bottlenecks > 0

    def compression_ratio(self, d_model: int, wire_bits: int = 16) -> float:
        """Compression vs the paper's fp32/d_model basis."""
        return (d_model * 32) / (self.bottleneck_dim * wire_bits)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    arch_id: str
    family: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    d_head: int = 0                      # 0 -> d_model // n_heads
    qk_norm: bool = False
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    moe: Optional[MoEConfig] = None
    bottleneck: BottleneckConfig = dataclasses.field(default_factory=BottleneckConfig)
    # --- family-specific knobs ---
    # hybrid (jamba): period layout; within each period of `hybrid_period`
    # blocks, block index `hybrid_attn_index` is attention, the rest Mamba.
    hybrid_period: int = 8
    hybrid_attn_index: int = 4
    # ssm (xlstm): alternation of mLSTM/sLSTM blocks; d_ff == 0 means the
    # blocks use their own up/down projections (proj_factor).
    xlstm_proj_factor: float = 2.0
    # mamba block hyperparams (jamba)
    mamba_d_state: int = 16
    mamba_d_conv: int = 4
    mamba_expand: int = 2
    # enc-dec (seamless): n_layers applies to BOTH encoder and decoder stacks.
    is_encoder_decoder: bool = False
    # vlm / audio frontends are stubs: input_specs() provides precomputed
    # frame/patch embeddings of width `frontend_embed_dim` == d_model.
    frontend_tokens: int = 0             # patches/frames prepended to the text
    # activations streamed between pipeline stages use this dtype on the wire
    # (paper: bf16 = 2x of fp32)
    max_seq_len: int = 1 << 20

    # ------------------------------------------------------------------
    @property
    def head_dim(self) -> int:
        return self.d_head or (self.d_model // self.n_heads)

    @property
    def padded_vocab(self) -> int:
        """Vocab padded to a multiple of 512 so embedding/logit matrices shard

        evenly on a 16-wide model axis (Megatron-style vocab padding; padded
        logits are masked to -inf, padded embedding rows are zero-init)."""
        return round_up(self.vocab_size, 512)

    @property
    def uses_attention(self) -> bool:
        return self.family != SSM

    @property
    def sub_quadratic(self) -> bool:
        """True if the arch supports O(1)/O(layer-subset) state at 500k ctx
        (shape rule: ``long_500k`` runs only for SSM/hybrid archs)."""
        return self.family in (SSM, HYBRID)

    def param_count(self) -> int:
        """Analytic parameter count (used for MODEL_FLOPS = 6*N*D)."""
        return _param_count(self)

    def active_param_count(self) -> int:
        """Active params per token (MoE: only top_k experts count)."""
        return _param_count(self, active_only=True)


def _ffn_params(cfg: ModelConfig, active_only: bool) -> int:
    """Per-layer FFN params (SwiGLU: 3 matrices)."""
    dense_ffn = 3 * cfg.d_model * cfg.d_ff
    if cfg.moe is None:
        return dense_ffn
    n = cfg.moe.top_k if active_only else cfg.moe.n_experts
    expert = 3 * cfg.d_model * cfg.d_ff * n
    router = cfg.d_model * cfg.moe.n_experts
    if cfg.moe.layer_pattern == "alternate":
        # half the layers dense, half MoE -> return the *average* per layer
        return (dense_ffn + expert + router) // 2
    return expert + router


def _attn_params(cfg: ModelConfig) -> int:
    hd = cfg.head_dim
    return (cfg.d_model * cfg.n_heads * hd          # wq
            + 2 * cfg.d_model * cfg.n_kv_heads * hd  # wk, wv
            + cfg.n_heads * hd * cfg.d_model)        # wo


def _mamba_params(cfg: ModelConfig) -> int:
    d_in = cfg.mamba_expand * cfg.d_model
    return (cfg.d_model * 2 * d_in                  # in_proj (x, z)
            + d_in * cfg.mamba_d_conv               # conv
            + d_in * (cfg.mamba_d_state * 2 + 1)    # B, C, dt proj (folded)
            + d_in * cfg.mamba_d_state              # A
            + d_in                                   # D
            + d_in * cfg.d_model)                   # out_proj


def _xlstm_params(cfg: ModelConfig) -> int:
    # mLSTM block: qkv + gates + up/down proj (proj_factor)
    d = cfg.d_model
    d_up = int(cfg.xlstm_proj_factor * d)
    mlstm = 3 * d * d + 2 * d + 2 * d * d_up + d_up * d
    slstm = 4 * d * d + 4 * d * d // max(cfg.n_heads, 1) + 2 * d * d_up + d_up * d
    return (mlstm + slstm) // 2  # alternating -> average per layer


def _param_count(cfg: ModelConfig, active_only: bool = False) -> int:
    embed = cfg.padded_vocab * cfg.d_model
    unembed = 0 if cfg.tie_embeddings else cfg.padded_vocab * cfg.d_model
    per_layer = 0
    if cfg.family == SSM:
        per_layer = _xlstm_params(cfg)
    elif cfg.family == HYBRID:
        n_attn = cfg.n_layers // cfg.hybrid_period
        n_mamba = cfg.n_layers - n_attn
        attn_side = n_attn * (_attn_params(cfg) + _ffn_params(cfg, active_only))
        mamba_side = n_mamba * (_mamba_params(cfg) + _ffn_params(cfg, active_only))
        total = attn_side + mamba_side + embed + unembed
        return total
    else:
        per_layer = _attn_params(cfg) + _ffn_params(cfg, active_only)
    n_stacks = 2 if cfg.is_encoder_decoder else 1
    cross = _attn_params(cfg) * cfg.n_layers if cfg.is_encoder_decoder else 0
    return embed + unembed + n_stacks * cfg.n_layers * per_layer + cross


# ---------------------------------------------------------------------------
# Input shapes (assigned shape set for the LM family)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str              # "train" | "prefill" | "decode"

    @property
    def is_train(self) -> bool:
        return self.kind == "train"


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


def applicable_shapes(cfg: ModelConfig) -> list[ShapeConfig]:
    """Shape rule: long_500k only for sub-quadratic archs."""
    out = []
    for s in SHAPES.values():
        if s.name == "long_500k" and not cfg.sub_quadratic:
            continue
        out.append(s)
    return out


# ---------------------------------------------------------------------------
# Parallelism / training configs
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ParallelConfig:
    """How a given (arch x shape) is laid out on the mesh."""
    strategy: str = "tensor"        # "tensor" (GSPMD TP+FSDP) | "pipeline"
    fsdp: bool = False              # shard params over the data axis too
    grad_accum: int = 1             # microbatch count (scan) per train step
    remat: bool = True              # activation checkpointing per block
    # pipeline strategy knobs
    pipeline_microbatches: int = 8
    # DiLoCo (paper §2.1): inner steps between outer merges, outer lr/momentum
    diloco_inner_steps: int = 64
    diloco_outer_lr: float = 0.7
    diloco_outer_momentum: float = 0.9
    # optimizer: "adamw" | "adafactor" (giant archs) | "sgdm"
    optimizer: str = "adamw"
    # dtype for optimizer 2nd-order state; bf16 halves optimizer HBM for
    # giant archs (noted in DESIGN.md hardware adaptation)
    opt_state_dtype: str = "float32"
    # master param dtype; "bfloat16" for the 1T-class archs where fp32 masters
    # cannot fit pod HBM (paired with adafactor + fp32 factored stats)
    param_dtype: str = "float32"
    # sequence-chunk size for recurrent scans (mamba/xlstm): outer scan over
    # chunks with a rematerialized inner scan bounds carry storage
    scan_chunk: int = 256
    # shard attention over q-heads when divisible; else batch-reshard scheme
    attn_batch_reshard: bool = False


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 1000
    weight_decay: float = 0.1
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    grad_clip: float = 1.0
    seed: int = 0
    z_loss: float = 1e-4            # logit regularizer, also stabilizes fp32 loss


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    """One assigned architecture: model + its default parallel/train configs."""
    model: ModelConfig
    parallel: ParallelConfig = dataclasses.field(default_factory=ParallelConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)
    source: str = ""                 # provenance tag from the assignment table

    def with_(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

ARCH_IDS: tuple[str, ...] = (
    "stablelm-3b",
    "qwen3-14b",
    "glm4-9b",
    "llama3.2-1b",
    "kimi-k2-1t-a32b",
    "olmoe-1b-7b",
    "xlstm-125m",
    "llava-next-34b",
    "seamless-m4t-medium",
    "jamba-v0.1-52b",
    # the paper's own reference model (§4: bottleneck-Llama3.2-1.5B)
    "iota-bottleneck-1.5b",
)

_MODULE_FOR_ARCH = {a: a.replace("-", "_").replace(".", "_") for a in ARCH_IDS}


def get(arch_id: str) -> ArchConfig:
    if arch_id not in _MODULE_FOR_ARCH:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(_MODULE_FOR_ARCH)}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULE_FOR_ARCH[arch_id]}")
    cfg = mod.CONFIG
    assert cfg.model.arch_id == arch_id, (cfg.model.arch_id, arch_id)
    return cfg


def all_arch_ids(include_paper_ref: bool = False) -> list[str]:
    ids = [a for a in ARCH_IDS if a != "iota-bottleneck-1.5b"]
    if include_paper_ref:
        ids.append("iota-bottleneck-1.5b")
    return ids


def smoke_variant(cfg: ArchConfig) -> ArchConfig:
    """Reduced same-family config for CPU smoke tests: small layers/width,

    few experts, tiny vocab — one forward/train step must run on CPU."""
    m = cfg.model
    moe = None
    if m.moe is not None:
        moe = dataclasses.replace(
            m.moe, n_experts=min(8, m.moe.n_experts), top_k=min(2, m.moe.top_k))
    n_layers = max(2, min(4, m.n_layers))
    if m.family == HYBRID:
        n_layers = m.hybrid_period  # one full period keeps the interleave
    bott = m.bottleneck
    if bott.enabled:
        bott = dataclasses.replace(bott, n_bottlenecks=1, bottleneck_dim=8)
    small = dataclasses.replace(
        m,
        n_layers=n_layers,
        d_model=64,
        n_heads=4,
        n_kv_heads=min(4, max(1, m.n_kv_heads * 4 // max(m.n_heads, 1))),
        d_head=16,
        d_ff=0 if m.d_ff == 0 else 128,
        vocab_size=512,
        moe=moe,
        bottleneck=bott,
        frontend_tokens=min(8, m.frontend_tokens),
        mamba_d_state=8,
    )
    par = dataclasses.replace(cfg.parallel, grad_accum=1, fsdp=False)
    return dataclasses.replace(cfg, model=small, parallel=par)
