"""glm4-9b [dense] — RoPE, GQA kv=2 — [hf:THUDM/glm-4-9b; hf]."""
from repro_torch.configs.base import ArchConfig, ModelConfig, ParallelConfig

CONFIG = ArchConfig(
    model=ModelConfig(
        arch_id="glm4-9b",
        family="dense",
        n_layers=40,
        d_model=4096,
        n_heads=32,
        n_kv_heads=2,        # kv heads replicated over the model axis
        d_ff=13696,
        vocab_size=151552,
        rope_theta=10000.0,
    ),
    parallel=ParallelConfig(grad_accum=16, fsdp=True),
    source="hf:THUDM/glm-4-9b; hf",
)
