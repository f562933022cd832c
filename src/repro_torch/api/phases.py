"""The serve plane's driver and stage workers (mirrors the serve part of
``repro/api/phases.py``).

The decode timetable (``compile_timetable("decode", P, n_lanes)``) is the
single source of execution order: micro-batch slots are request lanes, and
one round advances every active lane by one token.  The driver does
continuous batching: it admits queued requests into free lanes and retires
finished ones strictly between rounds, publishing one lane plan per round.
Stage compute is a ``StageServer`` per stage, called in timetable slot
order.  Sampling stays in the driver, so stages are deterministic functions
of store payloads and greedy decode reproduces the sequential oracle
``launch.serve.swarm_generate`` token for token.

The training phases (``EpochDriver`` and its phases) come with the training
slice.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Iterable, Optional

import numpy as np
import torch

from repro_torch.api.messages import (
    ServeCodeMsg,
    ServeDoneMsg,
    ServePlanMsg,
    ServeRequestMsg,
    ServeRoundPlanMsg,
    ServeTokenMsg,
)
from repro_torch.core.pipeline import ROLE_F, compile_timetable
from repro_torch.runtime import stage_model as sm


@dataclasses.dataclass
class ServeRequest:
    """One inference request: a prompt plus sampling parameters.

    ``arrival_round`` is the earliest decode round the scheduler may admit
    it (0 = available immediately) — tests use it to stagger mid-flight
    admissions deterministically."""
    req: int
    prompt: Any                  # (S,) int token ids (list or array)
    max_new: int = 16
    temperature: float = 0.0
    arrival_round: int = 0


@dataclasses.dataclass
class RequestRecord:
    """Per-request serving record: emitted tokens + latency breakdown."""
    req: int
    tokens: list = dataclasses.field(default_factory=list)
    submit_s: float = 0.0
    first_token_s: Optional[float] = None     # TTFT (prefill + first sample)
    done_s: Optional[float] = None
    token_s: list = dataclasses.field(default_factory=list)  # per-token stamps

    @property
    def ttft(self) -> Optional[float]:
        if self.first_token_s is None:
            return None
        return self.first_token_s - self.submit_s

    @property
    def total(self) -> Optional[float]:
        if self.done_s is None:
            return None
        return self.done_s - self.submit_s


class StageServer:
    """One stage's serve-side worker: a ``StageProgram`` + params + one
    stage-local KV cache per request lane.

    ``process_slot`` executes one (round, lane) timetable cell: fetch the
    stage input from the store (prompt tokens / last sampled token on the
    first stage, the upstream boundary code elsewhere), advance the lane's
    cache through the slice, publish the boundary output.  The store
    payloads are the only interface between stages, and they are host
    data; ``device`` is where this stage computes and keeps its caches."""

    def __init__(self, spec, stage: int, params, *, n_lanes: int,
                 max_len: int, wire_codec: str = "none",
                 device: str = "cuda"):
        self.program = sm.StageProgram(spec, stage, wire_codec, device)
        self.stage = stage
        self.params = params
        self.max_len = max_len
        self.caches = [self.program.init_cache(1, max_len)
                       for _ in range(n_lanes)]

    @property
    def actor(self) -> str:
        return f"server{self.stage}"

    def reset_lane(self, lane: int) -> None:
        """Admission: the lane's cache restarts from length 0 — lanes are
        independent batch rows, so this cannot perturb other lanes."""
        self.caches[lane] = self.program.init_cache(1, self.max_len)

    def process_slot(self, tp, schema, round_: int, entry: dict) -> None:
        lane, req = int(entry["lane"]), int(entry["req"])
        prefill = entry["phase"] == "prefill"
        if self.stage == 0:
            if prefill:
                env = tp.get(schema.serve_request(req), actor=self.actor)
                x = torch.as_tensor(env["tokens"], dtype=torch.int32,
                                    device=self.program.device)
            else:
                tok = tp.get(schema.serve_token(req, int(entry["in_index"])),
                             actor=self.actor)
                x = torch.as_tensor(tok, dtype=torch.int32,
                                    device=self.program.device).reshape(1, 1)
        else:
            payload = tp.get(schema.serve_code(round_, lane, self.stage - 1),
                             actor=self.actor)
            x = self.program.decode_wire(payload)
        if prefill:
            self.reset_lane(lane)
        out, self.caches[lane] = self.program.decode_step(
            self.params, x, self.caches[lane])
        if self.program.role in ("last", "solo"):
            # ship only the last position's logits: that is all sampling
            # needs, and it keeps the serve plane's store traffic O(vocab)
            # instead of O(prompt * vocab) on prefill rounds
            payload = {"code": out[:, -1].float().cpu()}
        else:
            payload = self.program.encode_wire(out)
        tp.publish(ServeCodeMsg(round_, lane, self.stage), payload,
                   actor=self.actor)


@dataclasses.dataclass
class _Lane:
    """Driver-side state of one occupied request lane."""
    req: int
    max_new: int
    temperature: float
    emitted: int = 0           # tokens sampled so far (== next token index)


class ServeDriver:
    """Continuous-batching decode driver over a transport.

    The driver owns admission/retirement, sampling and latency tracking;
    stage compute lives in the ``StageServer``s, whose slots the driver
    executes itself in compiled slot order (actor fleets that execute them
    remotely come with the multi-process slice).

    Greedy parity contract: at ``temperature=0`` the emitted tokens are
    bit-identical to ``launch.serve.swarm_generate`` (the sequential
    single-process oracle) at the same seed, for any stage count or
    admission order — lanes are independent batch rows and sampling
    generators derive from (seed, req, index) only.
    """

    def __init__(self, spec, transport, *, n_lanes: int, max_len: int,
                 servers: list, seed: int = 0,
                 wire_codec: str = "none"):
        self.spec = spec
        self.transport = transport
        self.schema = transport.schema
        self.n_lanes = n_lanes
        self.max_len = max_len
        self.servers = servers
        self.seed = seed
        self.wire_codec = wire_codec
        self.timetable = compile_timetable("decode", spec.n_stages, n_lanes)
        self.records: dict[int, RequestRecord] = {}
        self.rounds_run = 0

    # -- plumbing --------------------------------------------------------

    def publish_session_plan(self) -> None:
        """The one-shot session spec (what remote serve actors derive
        everything from; published here too, so the store holds what the
        reference's does)."""
        self.transport.publish(ServePlanMsg(), {
            "n_stages": self.spec.n_stages,
            "n_lanes": self.n_lanes,
            "max_len": self.max_len,
            "wire_codec": self.wire_codec,
            "seed": self.seed,
        }, actor="serve-driver")

    def _sample(self, req: int, index: int, temperature: float, logits):
        gen = sm.request_key(self.seed, req, index)
        return int(sm.sample_token(logits, temperature=temperature,
                                   gen=gen)[0])

    # -- the round loop --------------------------------------------------

    def run(self, requests: Iterable[ServeRequest]) -> dict:
        """Serve every request to completion; returns {req: RequestRecord}.

        Admission and retirement happen strictly between rounds: a request
        joining mid-flight lands in a free lane as a *prefill* slot of the
        next round while already-running lanes decode — the lane plan is
        the active-lane mask, and untouched lanes' caches are untouched
        state, so running requests' tokens cannot change (the regression
        test pins this).
        """
        tp, schema = self.transport, self.schema
        queue = sorted(requests, key=lambda r: (r.arrival_round, r.req))
        lanes: list[Optional[_Lane]] = [None] * self.n_lanes
        self.publish_session_plan()
        rnd = self.rounds_run
        while queue or any(lanes):
            entries = []
            # admission: free lanes pick up arrived requests (FIFO)
            for li in range(self.n_lanes):
                if lanes[li] is None and queue \
                        and queue[0].arrival_round <= rnd:
                    r = queue.pop(0)
                    prompt = np.asarray(r.prompt, np.int32).reshape(1, -1)
                    if prompt.shape[1] + r.max_new > self.max_len:
                        raise ValueError(
                            f"request {r.req}: prompt + max_new exceeds "
                            f"the lane KV capacity {self.max_len}")
                    tp.publish(ServeRequestMsg(r.req), {
                        "tokens": prompt,
                        "max_new": int(r.max_new),
                        "temperature": float(r.temperature),
                    }, actor="serve-driver")
                    rec = self.records.setdefault(r.req, RequestRecord(r.req))
                    rec.submit_s = time.perf_counter()
                    lanes[li] = _Lane(r.req, int(r.max_new),
                                      float(r.temperature))
                    entries.append({"lane": li, "req": r.req,
                                    "phase": "prefill"})
                elif lanes[li] is not None:
                    ln = lanes[li]
                    entries.append({"lane": li, "req": ln.req,
                                    "phase": "decode",
                                    "in_index": ln.emitted - 1})
            if not entries:
                # nothing admissible yet (future arrival_round): publish
                # the empty round anyway, as the reference does, so round
                # numbers and store traffic match it (not GC'd: it is tiny
                # and session-scoped)
                tp.publish(ServeRoundPlanMsg(rnd),
                           {"entries": [], "stop": False},
                           actor="serve-driver")
                rnd += 1
                continue
            tp.publish(ServeRoundPlanMsg(rnd),
                       {"entries": entries, "stop": False},
                       actor="serve-driver")
            self._run_slots(rnd, entries)
            self._collect(rnd, entries, lanes)
            tp.delete_prefix(schema.serve_round_prefix(rnd))
            rnd += 1
        self.rounds_run = rnd
        return self.records

    def _run_slots(self, rnd: int, entries: list) -> None:
        """Execute one round's cells in compiled timetable order: slot t,
        stage s acts on lane ``micro[s, t]`` iff the lane plan marks that
        lane active.  This is the store-and-forward realization of the
        decode schedule, in the (s, lane) dependency order of the compiled
        timetable."""
        tt = self.timetable
        by_lane = {e["lane"]: e for e in entries}
        for t in range(tt.n_slots):
            for s in range(tt.n_stages):
                if int(tt.role[s, t]) != ROLE_F:
                    continue
                entry = by_lane.get(int(tt.micro[s, t]))
                if entry is None:
                    continue          # inactive lane: masked-off cell
                self.servers[s].process_slot(
                    self.transport, self.schema, rnd, entry)

    def _collect(self, rnd: int, entries: list, lanes: list) -> None:
        """Fetch each active lane's last-stage logits, sample, publish the
        token, retire finished requests."""
        tp, schema = self.transport, self.schema
        last = self.spec.n_stages - 1
        for entry in entries:
            li = int(entry["lane"])
            ln = lanes[li]
            payload = tp.get(schema.serve_code(rnd, li, last),
                             actor="serve-driver")
            tok = self._sample(ln.req, ln.emitted, ln.temperature,
                               payload["code"])
            rec = self.records[ln.req]
            now = time.perf_counter()
            tp.publish(ServeTokenMsg(ln.req, ln.emitted),
                       np.asarray([[tok]], np.int32), actor="serve-driver")
            rec.tokens.append(tok)
            rec.token_s.append(now)
            if rec.first_token_s is None:
                rec.first_token_s = now
            ln.emitted += 1
            if ln.emitted >= ln.max_new:
                rec.done_s = now
                tp.publish(ServeDoneMsg(ln.req), {
                    "n_tokens": ln.emitted,
                    "ttft_s": rec.ttft,
                    "total_s": rec.total,
                }, actor="serve-driver")
                lanes[li] = None
