"""``Swarm`` — the facade over transport + phases + driver (mirrors
``repro/api/swarm.py``), in process.

    swarm = Swarm.create(model_cfg, SwarmConfig(seed=0))   # on the card
    stats = swarm.run(3)

    Swarm.create(model_cfg, SwarmConfig(seed=0), device="cpu")  # the host

Parameters, optimizer state, anchors and outer momentum live on ``device``
(the CUDA card unless the caller asks for the CPU; without a card the
default raises).  Stage weights are drawn from ``torch.Generator``s seeded
from ``(seed, stage)``; ``repro_torch.convert.load_swarm_state`` replaces
them with a JAX swarm's, so both packages can start from the same numbers.
The actor runtime, custom transports and the chaos knobs come with the
multi-process slice.
"""
from __future__ import annotations

from typing import Any, Iterable, Optional

import numpy as np

from repro_torch.api.config import EpochStats, SwarmConfig
from repro_torch.api.keys import KeySchema
from repro_torch.api.phases import EpochDriver
from repro_torch.api.transport import InProcessTransport
from repro_torch.common import generator, resolve_device, tree_to
from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.core import diloco
from repro_torch.core.incentives import IncentiveLedger
from repro_torch.core.pipeline import compile_timetable
from repro_torch.data.pipeline import DataConfig, SyntheticCorpus
from repro_torch.runtime import stage_model as sm
from repro_torch.runtime.miner import Miner
from repro_torch.runtime.network import FaultModel
from repro_torch.runtime.validator import Validator


def _multi_process(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet: it comes with the multi-process slice "
        f"(serde, socket store, actor fleets, chaos)")


class Swarm:
    def __init__(self, model_cfg: ModelConfig, config: SwarmConfig,
                 faults: Optional[FaultModel] = None,
                 train_cfg: Optional[TrainConfig] = None,
                 driver: Optional[EpochDriver] = None,
                 device: str = "cuda"):
        self.cfg = model_cfg
        self.config = config
        self.device = resolve_device(device)
        self.transport = InProcessTransport(schema=KeySchema())
        self.faults = faults or FaultModel({}, seed=config.seed)
        self.spec = sm.SwarmModelSpec(model_cfg, config.n_stages,
                                      config.compress, config.bottleneck_dim)
        self.train_cfg = train_cfg or TrainConfig(lr=1e-3, warmup_steps=20)
        self.rng = np.random.RandomState(config.seed)
        self.ledger = IncentiveLedger(config.gamma_hours)
        self.corpus = SyntheticCorpus(DataConfig(
            vocab_size=model_cfg.vocab_size, seq_len=config.seq_len,
            batch_size=config.batch_size, seed=config.seed))
        self.driver = driver or EpochDriver()
        self.global_tick = 0
        self.epoch = 0

        # per-stage anchors + DiLoCo outer state (the shared model)
        self.anchors: list[Any] = []
        self.outer: list[diloco.OuterState] = []
        for s in range(config.n_stages):
            p = sm.init_stage_params(
                generator(self.device, "swarm-params", config.seed, s),
                self.spec, s)
            self.anchors.append(p)
            self.outer.append(diloco.outer_init(p))

        # register miners: uid = stage * miners_per_stage + slot
        self.miners: dict[int, Miner] = {}
        for s in range(config.n_stages):
            for _ in range(config.miners_per_stage):
                self.register_miner(stage=s)

        self.validators = [Validator(v, self.transport, self.ledger)
                           for v in range(config.validators)]
        self.history: list[EpochStats] = []

    @classmethod
    def create(cls, model_cfg: ModelConfig,
               config: Optional[SwarmConfig] = None, *,
               faults: Optional[FaultModel] = None,
               transport: Any = None,
               train_cfg: Optional[TrainConfig] = None,
               phases: Optional[Iterable] = None,
               runtime: str = "inprocess",
               store_address: Optional[tuple] = None,
               snapshot_root: Optional[str] = None,
               chaos: Any = None,
               store_standby: bool = False,
               device: str = "cuda") -> "Swarm":
        """Build the lockstep in-process swarm on ``device``."""
        config = config or SwarmConfig()
        # fail fast on pipeline knobs that do not compile to a timetable
        compile_timetable(config.pipeline_schedule, config.n_stages,
                          config.pipeline_microbatches,
                          config.pipeline_virtual_stages)
        if runtime == "actors":
            raise _multi_process("runtime='actors'")
        if runtime != "inprocess":
            raise ValueError(
                f"unknown runtime {runtime!r}: 'inprocess' or 'actors'")
        if transport is not None:
            raise _multi_process("a transport other than the in-process one")
        if (store_address is not None or snapshot_root is not None
                or chaos is not None or store_standby):
            raise _multi_process("store_address=/snapshot_root=/chaos=/"
                                 "store_standby=")
        driver = EpochDriver(phases) if phases is not None else None
        return cls(model_cfg, config, faults=faults, train_cfg=train_cfg,
                   driver=driver, device=device)

    @property
    def store(self):
        """The backing StateStore of the in-process transport."""
        return self.transport.store

    def register_miner(self, stage: int) -> Miner:
        """Join at any time; the miner starts from a copy of its stage's
        anchor ('copying existing miners' states', section 2.2)."""
        uid = len(self.miners)
        m = Miner(uid, stage, self.spec, tree_to(self.anchors[stage],
                                                 self.device),
                  self.transport, self.train_cfg, device=self.device)
        self.miners[uid] = m
        return m

    def stage_miners(self, stage: int) -> list[Miner]:
        return [m for m in self.miners.values() if m.stage == stage]

    def available(self, m: Miner, tick: int) -> bool:
        """Fault-model gate the TrainingPhase consults per (miner, tick).
        Draws from the fault RNG on every call: call order is part of the
        determinism contract."""
        b = self.faults.behavior(m.uid)
        if self.faults.is_dropped(m.uid):
            return False
        period = max(int(round(b.straggle_factor)), 1)
        return tick % period == 0

    def run_epoch(self) -> EpochStats:
        return self.driver.run_epoch(self)

    def run(self, n_epochs: int) -> list[EpochStats]:
        return [self.run_epoch() for _ in range(n_epochs)]
