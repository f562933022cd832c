"""Miner: one layer-slice worker (paper section 2.2; mirrors
``repro/runtime/miner.py``).

Holds stage params + a local inner optimizer (the DiLoCo inner loop), streams
activations through its transport, keeps a local work log that validators
can replay.  Parameters and optimizer state live on ``device``; store
payloads are host data, so what a miner reads from the store it first moves
to its device.  The sharded sync's ``run_reduce`` comes with a later slice.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.common import ravel, tree_to, unravel_like
from repro_torch.configs.base import TrainConfig
from repro_torch.optim import adamw
from repro_torch.optim.schedules import cosine_warmup
from repro_torch.runtime import stage_model as sm


@dataclasses.dataclass
class WorkItem:
    """One forward(+backward) unit, logged for validator replay."""
    tick: int
    sample_key: str          # store key of the input activation / tokens
    out_key: str             # store key of this miner's uploaded output
    did_backward: bool = False


def make_optimizer(train_cfg: Optional[TrainConfig] = None):
    """The miners' inner AdamW with its cosine-warmup schedule."""
    tc = train_cfg or TrainConfig(lr=1e-3, warmup_steps=20)
    return adamw(cosine_warmup(tc.lr, tc.warmup_steps, 10_000),
                 beta1=tc.beta1, beta2=tc.beta2,
                 weight_decay=tc.weight_decay)


def as_device_tensor(x: Any, device: str) -> torch.Tensor:
    """A store payload (numpy array or host tensor) on ``device``."""
    if not isinstance(x, torch.Tensor):
        x = torch.as_tensor(np.asarray(x))
    return x.to(device)


class Miner:
    def __init__(self, uid: int, stage: int, spec: sm.SwarmModelSpec,
                 params: Any, transport,
                 train_cfg: Optional[TrainConfig] = None,
                 device: str = "cuda"):
        self.uid = uid
        self.stage = stage
        self.spec = spec
        self.role = spec.role(stage)
        self.transport = transport
        self.device = device
        self.params = params
        self.opt = make_optimizer(train_cfg)
        self.opt_state = self.opt.init(params)
        self.inner_step = 0
        self.batches_done = 0
        self.work_log: list[WorkItem] = []
        self._pending: dict[str, Any] = {}     # sample_key -> input (for bwd)

    @property
    def actor(self) -> str:
        return f"miner{self.uid}"

    def forward(self, tick: int, sample_key: str, out_key: str) -> Any:
        """Read input from the store, apply the stage, upload the output."""
        x_in = as_device_tensor(
            self.transport.get(sample_key, actor=self.actor), self.device)
        out = sm.stage_forward(self.params, x_in, self.spec, self.role)
        self._pending[sample_key] = x_in
        self.transport.put(out_key, out, actor=self.actor)
        self.work_log.append(WorkItem(tick, sample_key, out_key))
        return out

    def backward_last(self, sample_key: str, labels) -> tuple[float, Any]:
        """Last-stage miner: compute loss + grads, return (loss, g_z_in)."""
        z_in = self._pending.pop(sample_key)
        loss, g_params, g_z = sm.last_stage_loss_and_grads(
            self.params, z_in, labels, self.spec)
        self._apply(g_params)
        return float(loss), g_z

    def backward(self, sample_key: str, g_out) -> Any:
        """Mid/first miner: VJP through the recomputed stage forward."""
        x_in = self._pending.pop(sample_key)
        g_params, g_x = sm.stage_backward(self.params, x_in, g_out,
                                          self.spec, self.role)
        self._apply(g_params)
        return g_x

    def _apply(self, grads) -> None:
        self.params, self.opt_state = self.opt.update(
            grads, self.opt_state, self.params, self.inner_step)
        self.inner_step += 1
        self.batches_done += 1
        if self.work_log:
            self.work_log[-1].did_backward = True

    # ------------------------------------------------------------------
    # weight exchange (one flattened f32 vector, paper section 5.1)
    # ------------------------------------------------------------------

    def weights_vector(self) -> torch.Tensor:
        """The parameters as one f32 vector on the miner's device, in
        ``ravel_pytree``'s layout (the reference returns it as numpy)."""
        flat, _ = ravel(self.params)
        return flat

    def load_weights_vector(self, vec) -> None:
        """Replace the parameters with ``vec`` (numpy or tensor), cut into
        this miner's tree; the new leaves are views of one device copy."""
        self.params = unravel_like(self.params, torch.as_tensor(
            np.asarray(vec, np.float32)).to(self.device, copy=True))

    def reset_epoch(self) -> None:
        self.batches_done = 0
        self.work_log = []
        self._pending = {}

    def snapshot(self) -> dict:
        """State a validator copies at full sync to track this miner.  The
        copies are host tensors: a snapshot of every miner at full width
        (9 GB each) would not fit on the card beside the miners, and the
        validator moves only its tracked miner's snapshot to the card."""
        return {"params": tree_to(self.params, "cpu"),
                "opt_state": tree_to(self.opt_state, "cpu"),
                "inner_step": self.inner_step}
