"""llama3.2-1b [dense] — small llama3 — [hf:meta-llama/Llama-3.2-1B; unverified]."""
from repro_torch.configs.base import ArchConfig, ModelConfig, ParallelConfig

CONFIG = ArchConfig(
    model=ModelConfig(
        arch_id="llama3.2-1b",
        family="dense",
        n_layers=16,
        d_model=2048,
        n_heads=32,
        n_kv_heads=8,
        d_ff=8192,
        vocab_size=128256,
        rope_theta=500000.0,
    ),
    parallel=ParallelConfig(grad_accum=8),
    source="hf:meta-llama/Llama-3.2-1B; unverified",
)
