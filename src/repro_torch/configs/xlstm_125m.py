"""xlstm-125m [ssm] — sLSTM + mLSTM blocks — [arXiv:2405.04517; unverified].

d_ff = 0: the xLSTM blocks carry their own up/down projections
(proj_factor 2.0) instead of a separate FFN.  Sub-quadratic state =>
``long_500k`` runs for this arch.
"""
from repro_torch.configs.base import ArchConfig, ModelConfig, ParallelConfig

CONFIG = ArchConfig(
    model=ModelConfig(
        arch_id="xlstm-125m",
        family="ssm",
        n_layers=12,
        d_model=768,
        n_heads=4,
        n_kv_heads=4,
        d_ff=0,
        vocab_size=50304,
        xlstm_proj_factor=2.0,
    ),
    parallel=ParallelConfig(grad_accum=4),
    source="arXiv:2405.04517; unverified",
)
