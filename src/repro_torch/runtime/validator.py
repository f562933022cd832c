"""Validator (paper sections 2.3 and 3; mirrors ``validate_epoch`` of
``repro/runtime/validator.py``): computational-reproducibility auditing.

At full sync the validator copies a target miner's state; during the epoch
it re-runs the miner's logged work *in order* (forward from the same store
inputs, backward with the same gradients), comparing its own outputs to the
miner's uploads by cosine similarity.  Deviation below threshold => the
work is rejected; the epoch score is the count of *validated* backward
passes.  The replay runs on the miner's device from the snapshot's host
copy.  The sharded sync's reduce audits come with a later slice.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.common import cosine_similarity, tree_to
from repro_torch.core import compression
from repro_torch.core.incentives import IncentiveLedger
from repro_torch.runtime import stage_model as sm
from repro_torch.runtime.miner import Miner, as_device_tensor

COSINE_THRESHOLD = 0.99


@dataclasses.dataclass
class ValidationResult:
    miner_uid: int
    epoch: int
    checked: int
    passed: int
    score: float                 # validated backward passes
    min_cosine: float

    @property
    def honest(self) -> bool:
        return self.checked == 0 or self.passed == self.checked


class Validator:
    def __init__(self, uid: int, transport, ledger: IncentiveLedger):
        self.uid = uid
        self.transport = transport
        self.ledger = ledger
        self.results: list[ValidationResult] = []

    @property
    def actor(self) -> str:
        return f"validator{self.uid}"

    def validate_epoch(self, miner: Miner, snapshot: dict, epoch: int,
                       t_now: float, labels_for: dict,
                       max_items: Optional[int] = None) -> ValidationResult:
        """Replay ``miner``'s logged epoch from ``snapshot`` (its full-sync
        state).  ``labels_for`` maps sample_key -> labels (the validator
        reads the same dataset shard).  Scores are assigned per section 3."""
        dev = miner.device
        params = tree_to(snapshot["params"], dev)
        opt_state = tree_to(snapshot["opt_state"], dev)
        inner_step = snapshot["inner_step"]
        opt = miner.opt
        spec, role = miner.spec, miner.role
        get = lambda key: as_device_tensor(   # noqa: E731
            self.transport.get(key, actor=self.actor), dev)

        checked = passed = 0
        validated_backwards = 0.0
        min_cos = 1.0
        items = (miner.work_log if max_items is None
                 else miner.work_log[:max_items])
        for item in items:
            x_in = get(item.sample_key)
            mine = sm.stage_forward(params, x_in, spec, role)
            theirs = get(item.out_key)
            cos = float(cosine_similarity(mine, theirs))
            checked += 1
            min_cos = min(min_cos, cos)
            ok = cos >= COSINE_THRESHOLD
            passed += int(ok)
            if not item.did_backward:
                continue
            # replay the miner's local update so later items line up
            if role == "last":
                labels = labels_for[item.sample_key]
                _, g_params, _ = sm.last_stage_loss_and_grads(
                    params, x_in, labels, spec)
            else:
                g_out_key = self.transport.schema.gradient_for(item.out_key)
                if not self.transport.exists(g_out_key):
                    continue
                g_out = self.transport.get(g_out_key, actor=self.actor)
                if isinstance(g_out, dict) and g_out.get("codec"):
                    # int8 gradient wire: replay with the same dequantized
                    # codes the miner trained on
                    payload = {k: as_device_tensor(v, dev)
                               if k in ("data", "scales") else v
                               for k, v in g_out.items()}
                    g_out = compression.decode(payload).reshape(
                        g_out["shape"])
                else:
                    g_out = as_device_tensor(g_out, dev)
                g_params, _ = sm.stage_backward(params, x_in, g_out, spec,
                                                role)
            params, opt_state = opt.update(g_params, opt_state, params,
                                           inner_step)
            inner_step = inner_step + 1
            if ok:
                validated_backwards += 1.0

        result = ValidationResult(miner.uid, epoch, checked, passed,
                                  validated_backwards, min_cos)
        self.results.append(result)
        self.ledger.record(miner.uid, epoch, result.score, t_now)
        return result
