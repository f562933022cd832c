"""qwen3-14b [dense] — qk_norm, GQA — [hf:Qwen/Qwen3-8B; hf]."""
from repro_torch.configs.base import ArchConfig, ModelConfig, ParallelConfig

CONFIG = ArchConfig(
    model=ModelConfig(
        arch_id="qwen3-14b",
        family="dense",
        n_layers=40,
        d_model=5120,
        n_heads=40,          # 40 % 16 != 0 -> attention uses batch-reshard
        n_kv_heads=8,
        d_ff=17408,
        vocab_size=151936,
        qk_norm=True,
        rope_theta=1_000_000.0,
    ),
    parallel=ParallelConfig(grad_accum=16, fsdp=True),
    source="hf:Qwen/Qwen3-8B; hf",
)
