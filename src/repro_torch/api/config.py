"""Swarm-level configuration + per-epoch stats (mirrors
``repro/api/config.py``).

The port runs the dense sync of the in-process swarm.  ``sync_mode=
"sharded"`` (the store-and-forward butterfly of KeySchema v2) raises,
naming the slice that brings it; the on-mesh pipeline knobs are checked
against the port's schedule registry as in the reference, and the
``PipelineSpec`` they describe comes with the pipeline-engine slice.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch.core import clasp
from repro_torch.core.pipeline import SCHEDULES


@dataclasses.dataclass(frozen=True)
class SwarmConfig:
    n_stages: int = 3
    miners_per_stage: int = 3
    inner_steps: int = 8              # ticks per epoch (training stage)
    b_min: int = 4                    # BATCHES_BEFORE_MERGING
    quorum_frac: float = 0.5
    batch_size: int = 4
    seq_len: int = 32
    compress: bool = True
    bottleneck_dim: int = 16
    share_codec: str = "int8"         # compressed-sharing stage codec
    # weight-exchange path for sharing+sync: "dense" (full vectors through
    # the store, butterfly reduced centrally in-process) is the one ported
    sync_mode: str = "dense"
    # backward-wire codec for TrainingPhase gradient hand-offs: "none" or
    # "int8" (blockwise-int8 gradient codes through the store)
    wire_codec: str = "none"
    pipeline_schedule: str = "gpipe"
    pipeline_virtual_stages: int = 1
    pipeline_microbatches: int = 8
    outer_lr: float = 0.7
    outer_momentum: float = 0.9
    gamma_hours: float = 10.0         # score decay
    sync_interval_hours: float = 0.5  # T_s
    validators: int = 1
    validate_max_items: Optional[int] = None
    # keep only the last ``retain_epochs`` epochs of the weights/ and
    # scores/ planes (activations are always GC'd at epoch end); None keeps
    # everything
    retain_epochs: Optional[int] = None
    seed: int = 0

    def __post_init__(self):
        if self.wire_codec not in ("none", "int8"):
            raise ValueError(f"unknown wire codec {self.wire_codec!r}")
        if self.pipeline_schedule not in SCHEDULES:
            raise ValueError(f"unknown pipeline schedule "
                             f"{self.pipeline_schedule!r}")
        if self.pipeline_virtual_stages < 1:
            raise ValueError(f"pipeline_virtual_stages must be >= 1: "
                             f"{self.pipeline_virtual_stages}")
        if self.sync_mode == "sharded":
            raise NotImplementedError(
                "sync_mode='sharded' (ButterflyExecutor, KeySchema v2) is "
                "not ported yet: it comes with the sharded-sync slice")
        if self.sync_mode != "dense":
            raise ValueError(f"unknown sync mode {self.sync_mode!r}")
        if self.retain_epochs is not None and self.retain_epochs < 1:
            raise ValueError(f"retain_epochs must be None or >= 1: "
                             f"{self.retain_epochs}")


@dataclasses.dataclass
class EpochStats:
    epoch: int
    mean_loss: float
    b_eff: int
    batches: dict[int, int]
    merged_stages: int
    stalled_ticks: int
    agreement: dict[int, np.ndarray]      # stage -> (n,n) agreement matrix
    clasp: Optional[clasp.ClaspReport]
    validation: list
    emissions: dict[int, float]
