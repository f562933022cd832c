"""stablelm-3b [dense] — [hf:stabilityai/stablelm-2-1_6b; unverified]."""
from repro_torch.configs.base import ArchConfig, ModelConfig, ParallelConfig

CONFIG = ArchConfig(
    model=ModelConfig(
        arch_id="stablelm-3b",
        family="dense",
        n_layers=32,
        d_model=2560,
        n_heads=32,
        n_kv_heads=32,
        d_ff=6912,
        vocab_size=50304,
    ),
    parallel=ParallelConfig(grad_accum=8),
    source="hf:stabilityai/stablelm-2-1_6b; unverified",
)
