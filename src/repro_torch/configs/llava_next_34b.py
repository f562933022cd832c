"""llava-next-34b [vlm] — anyres tiling — [hf:llava-hf/llava-v1.6-mistral-7b-hf;

unverified].  Backbone only per the assignment; the ViT frontend is a stub
(``input_specs`` feeds 2880 = 5 tiles x 576 precomputed patch embeddings).
"""
from repro_torch.configs.base import ArchConfig, ModelConfig, ParallelConfig

# anyres tiling: a 672x672 image = 1 base 336px tile + 4 crops, 576 patches
# each (the frontend geometry of the JAX package's models/frontends.py)
LLAVA_ANYRES_TILES = 5
LLAVA_PATCHES_PER_TILE = 576
LLAVA_FRONTEND_TOKENS = LLAVA_ANYRES_TILES * LLAVA_PATCHES_PER_TILE  # 2880

CONFIG = ArchConfig(
    model=ModelConfig(
        arch_id="llava-next-34b",
        family="vlm",
        n_layers=60,
        d_model=7168,
        n_heads=56,          # 56 % 16 != 0 -> attention uses batch-reshard
        n_kv_heads=8,
        d_ff=20480,
        vocab_size=64000,
        frontend_tokens=LLAVA_FRONTEND_TOKENS,
        rope_theta=5_000_000.0,
    ),
    parallel=ParallelConfig(grad_accum=16, fsdp=True),
    source="hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified",
)
