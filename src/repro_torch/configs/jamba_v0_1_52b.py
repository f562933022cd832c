"""jamba-v0.1-52b [hybrid] — Mamba+attn 1:7 interleave, MoE 16e top-2 —

[arXiv:2403.19887; hf].  Period of 8 blocks: index 4 is attention, the rest
Mamba; MoE FFN on odd block indices (alternate), dense FFN on even.
Sub-quadratic (mamba state O(1); 4/32 attention layers keep a KV cache) =>
``long_500k`` runs for this arch.
"""
from repro_torch.configs.base import ArchConfig, ModelConfig, MoEConfig, ParallelConfig

CONFIG = ArchConfig(
    model=ModelConfig(
        arch_id="jamba-v0.1-52b",
        family="hybrid",
        n_layers=32,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        d_ff=14336,
        vocab_size=65536,
        moe=MoEConfig(n_experts=16, top_k=2, layer_pattern="alternate"),
        hybrid_period=8,
        hybrid_attn_index=4,
        mamba_d_state=16,
        mamba_d_conv=4,
        mamba_expand=2,
    ),
    parallel=ParallelConfig(grad_accum=8, fsdp=True),
    source="arXiv:2403.19887; hf",
)
