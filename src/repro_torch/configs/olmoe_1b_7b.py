"""olmoe-1b-7b [moe] — 64 experts top-8 — [arXiv:2409.02060; hf]."""
from repro_torch.configs.base import ArchConfig, ModelConfig, MoEConfig, ParallelConfig

CONFIG = ArchConfig(
    model=ModelConfig(
        arch_id="olmoe-1b-7b",
        family="moe",
        n_layers=16,
        d_model=2048,
        n_heads=16,
        n_kv_heads=16,
        d_ff=1024,           # per-expert FFN width
        vocab_size=50304,
        moe=MoEConfig(n_experts=64, top_k=8),
    ),
    parallel=ParallelConfig(grad_accum=8),
    source="arXiv:2409.02060; hf",
)
