"""Typed serve-plane messages (frozen dataclasses; mirrors the KeySchema v5
part of ``repro/api/messages.py``).

A message knows its own store key via ``key(schema)``; payloads ride next
to the envelope (``Transport.publish(msg, payload)``):

  ServePlanMsg       the serve session spec (stages, lanes, wire codec)
  ServeRoundPlanMsg  one decode round's lane plan (admission/retire)
  ServeCodeMsg       a stage's boundary output for one (round, lane)
  ServeRequestMsg    a request's prompt envelope
  ServeTokenMsg      one emitted token of a request
  ServeDoneMsg       request completion marker (latency stats payload)

The training-plane messages come with the training slice.
"""
from __future__ import annotations

import dataclasses
from typing import Union

from repro_torch.api.keys import KeySchema


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



Message = Union[ServePlanMsg, ServeRoundPlanMsg, ServeCodeMsg,
                ServeRequestMsg, ServeTokenMsg, ServeDoneMsg]
