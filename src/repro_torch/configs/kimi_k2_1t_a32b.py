"""kimi-k2-1t-a32b [moe] — trillion-param MoE (paper-table) —

[arXiv:2501.kimi2; unverified].

Memory plan (why this config differs from the defaults): ~1.03T params.
bf16 masters + Adafactor factored stats + FSDP over (data x model) is the
only way a 1T model approaches v5e HBM: params 2 TB + grads 2 TB at step
peak = 4 TB ≈ the ENTIRE 256-chip pod HBM (4.1 TB), so single-pod train_4k
is reported as over-budget in EXPERIMENTS.md §Dry-run and the multi-pod
(512-chip) mesh is the fitting configuration.
"""
from repro_torch.configs.base import ArchConfig, ModelConfig, MoEConfig, ParallelConfig

CONFIG = ArchConfig(
    model=ModelConfig(
        arch_id="kimi-k2-1t-a32b",
        family="moe",
        n_layers=61,
        d_model=7168,
        n_heads=64,
        n_kv_heads=8,
        d_ff=2048,           # per-expert FFN width
        vocab_size=163840,
        moe=MoEConfig(n_experts=384, top_k=8, int8_fsdp_gather=True),
        rope_theta=50000.0,
    ),
    parallel=ParallelConfig(
        grad_accum=8,
        fsdp=True,
        optimizer="adafactor",
        param_dtype="bfloat16",
    ),
    source="arXiv:2501.kimi2; unverified",
)
