"""seamless-m4t-medium [audio] — enc-dec, multimodal — [arXiv:2308.11596; hf].

n_layers=12 applies to BOTH stacks (12 encoder + 12 decoder).  The speech
frontend is a stub: the encoder consumes precomputed fbank-conv frame
embeddings (B, F, 1024); F = seq_len/4 capped at 4096 (DESIGN.md).
vocab 256206 is padded to 256512 for even model-axis sharding
(Megatron-style; padded logits masked to -inf).
"""
from repro_torch.configs.base import ArchConfig, ModelConfig, ParallelConfig

CONFIG = ArchConfig(
    model=ModelConfig(
        arch_id="seamless-m4t-medium",
        family="audio",
        n_layers=12,
        d_model=1024,
        n_heads=16,
        n_kv_heads=16,
        d_ff=4096,
        vocab_size=256206,
        is_encoder_decoder=True,
    ),
    parallel=ParallelConfig(grad_accum=8),
    source="arXiv:2308.11596; hf",
)
