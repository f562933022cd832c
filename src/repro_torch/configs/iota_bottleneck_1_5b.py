"""iota-bottleneck-1.5b — the PAPER'S OWN reference model (§4, Fig 5).

'Modified Llama3.2-1.5B': 16 layers, d_model 2048, with 3 bottleneck blocks
of width 32 — the paper's headline 128x case (fp32 basis: 2048*32 bits ->
32*16 bits).  This config is the subject of the convergence benchmark
(benchmarks/bench_convergence.py) and the pipeline-strategy perf cell.
"""
from repro_torch.configs.base import (
    ArchConfig,
    BottleneckConfig,
    ModelConfig,
    ParallelConfig,
)

CONFIG = ArchConfig(
    model=ModelConfig(
        arch_id="iota-bottleneck-1.5b",
        family="dense",
        n_layers=16,
        d_model=2048,
        n_heads=32,
        n_kv_heads=8,
        d_ff=8192,
        vocab_size=128256,
        rope_theta=500000.0,
        bottleneck=BottleneckConfig(n_bottlenecks=3, bottleneck_dim=32),
    ),
    parallel=ParallelConfig(grad_accum=1),
    source="paper §4 (Llama3.2-1.5B + 3 bottlenecks, 128x)",
)
