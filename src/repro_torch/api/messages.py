"""Typed peer-protocol messages (frozen dataclasses; mirrors the KeySchema
v1 and v5 parts of ``repro/api/messages.py``).

A message knows its own store key via ``key(schema)``; payloads ride next
to the envelope (``Transport.publish(msg, payload)``).  The train plane
(v1):

  ActivationMsg    forward wire codes (plus pipeline-entry tokens)
  GradientMsg      backward wire gradients
  WeightUploadMsg  compressed weight uploads (sharing stage, section 2.1)
  AnchorMsg        merged per-stage anchor after butterfly + DiLoCo outer
  ScoreMsg         validator scores feeding the incentive ledger (section 3)

The serve plane (v5):

  ServePlanMsg       the serve session spec (stages, lanes, wire codec)
  ServeRoundPlanMsg  one decode round's lane plan (admission/retire)
  ServeCodeMsg       a stage's boundary output for one (round, lane)
  ServeRequestMsg    a request's prompt envelope
  ServeTokenMsg      one emitted token of a request
  ServeDoneMsg       request completion marker (latency stats payload)

The messages of versions 2-4 come with later slices.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Union

from repro_torch.api.keys import KeySchema


@dataclasses.dataclass(frozen=True)
class ActivationMsg:
    """A boundary activation.  ``stage is None`` marks the pipeline entry
    (the orchestrator's token batch, produced by no miner)."""
    epoch: int
    tick: int
    stage: Optional[int] = None
    miner_uid: Optional[int] = None

    @classmethod
    def tokens(cls, epoch: int, tick: int) -> "ActivationMsg":
        return cls(epoch, tick)

    @property
    def is_tokens(self) -> bool:
        return self.stage is None

    def key(self, schema: KeySchema) -> str:
        if self.is_tokens:
            return schema.tokens(self.epoch, self.tick)
        return schema.activation(self.epoch, self.tick, self.stage,
                                 self.miner_uid)


@dataclasses.dataclass(frozen=True)
class GradientMsg:
    """Gradient w.r.t. the activation miner_uid uploaded at (tick, stage)."""
    epoch: int
    tick: int
    stage: int
    miner_uid: int

    def key(self, schema: KeySchema) -> str:
        return schema.gradient(self.epoch, self.tick, self.stage,
                               self.miner_uid)


@dataclasses.dataclass(frozen=True)
class WeightUploadMsg:
    """A qualifying miner's compressed weight vector (sharing stage)."""
    epoch: int
    stage: int
    miner_uid: int
    # advisory (the payload is already encoded) and not part of the key
    codec: str = dataclasses.field(default="int8", compare=False)

    def key(self, schema: KeySchema) -> str:
        return schema.weight_upload(self.epoch, self.stage, self.miner_uid)


@dataclasses.dataclass(frozen=True)
class AnchorMsg:
    """The merged per-stage anchor every miner downloads at full sync."""
    epoch: int
    stage: int

    def key(self, schema: KeySchema) -> str:
        return schema.anchor(self.epoch, self.stage)


@dataclasses.dataclass(frozen=True)
class ScoreMsg:
    """A validator's epoch verdict on one tracked miner."""
    epoch: int
    validator_uid: int
    miner_uid: int

    def key(self, schema: KeySchema) -> str:
        return schema.score(self.epoch, self.validator_uid, self.miner_uid)


@dataclasses.dataclass(frozen=True)
class ServePlanMsg:
    """The serve session spec (KeySchema v5): published once per session
    so serve actors can derive stage programs, lane caches and every
    later key from one store read."""

    def key(self, schema: KeySchema) -> str:
        return schema.serve_plan()


@dataclasses.dataclass(frozen=True)
class ServeRoundPlanMsg:
    """One decode round's lane plan (KeySchema v5): which request
    occupies each lane and whether its slot is a prefill (admission) or
    a decode step — the driver's continuous-batching decisions, made
    between rounds so stage actors never recompile."""
    round: int

    def key(self, schema: KeySchema) -> str:
        return schema.serve_round_plan(self.round)


@dataclasses.dataclass(frozen=True)
class ServeCodeMsg:
    """Stage ``stage``'s boundary output for ``lane`` in round ``round``
    — a bottleneck wire code mid-chain (optionally the physical int8
    pair), last-token logits on the final stage."""
    round: int
    lane: int
    stage: int

    def key(self, schema: KeySchema) -> str:
        return schema.serve_code(self.round, self.lane, self.stage)


@dataclasses.dataclass(frozen=True)
class ServeRequestMsg:
    """Request ``req``'s prompt envelope (tokens + sampling params ride
    the payload)."""
    req: int

    def key(self, schema: KeySchema) -> str:
        return schema.serve_request(self.req)


@dataclasses.dataclass(frozen=True)
class ServeTokenMsg:
    """Token ``index`` emitted for request ``req`` (index 0 is the first
    sampled continuation of the prompt)."""
    req: int
    index: int

    def key(self, schema: KeySchema) -> str:
        return schema.serve_token(self.req, self.index)


@dataclasses.dataclass(frozen=True)
class ServeDoneMsg:
    """Completion marker for request ``req``; the payload carries the
    per-request latency record."""
    req: int

    def key(self, schema: KeySchema) -> str:
        return schema.serve_done(self.req)


Message = Union[ActivationMsg, GradientMsg, WeightUploadMsg, AnchorMsg,
                ScoreMsg, ServePlanMsg, ServeRoundPlanMsg, ServeCodeMsg,
                ServeRequestMsg, ServeTokenMsg, ServeDoneMsg]
