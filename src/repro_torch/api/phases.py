"""The epoch timeline of the training swarm and the serve plane's driver
(mirrors ``repro/api/phases.py``).

Training: ``EpochDriver`` runs the phase list of ``default_phases()`` over
a swarm, in the reference's order and with its RNG call order (routing,
fault draws, validator choice), then folds the epoch into ``EpochStats``:

  TrainingPhase    CLASP-sampled pathways, forward/backward over the
                   transport, SWARM rerouting, stragglers
  ValidationPhase  validators replay tracked miners from their epoch-start
                   snapshots (before the merge, as in the reference)
  SharingPhase     qualifying miners upload codec-compressed weights
  SyncPhase        butterfly all-reduce (K3 on the card) + DiLoCo outer
                   step + anchor download for everyone

The sharded sync, the overlapped and event-driven timelines come with later
slices.

Serving: the decode timetable (``compile_timetable("decode", P, n_lanes)``) is the
single source of execution order: micro-batch slots are request lanes, and
one round advances every active lane by one token.  The driver does
continuous batching: it admits queued requests into free lanes and retires
finished ones strictly between rounds, publishing one lane plan per round.
Stage compute is a ``StageServer`` per stage, called in timetable slot
order.  Sampling stays in the driver, so stages are deterministic functions
of store payloads and greedy decode reproduces the sequential oracle
``launch.serve.swarm_generate`` token for token.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Iterable, Optional

import numpy as np
import torch

from repro_torch.api.config import EpochStats
from repro_torch.api.messages import (
    ActivationMsg,
    AnchorMsg,
    GradientMsg,
    ScoreMsg,
    ServeCodeMsg,
    ServeDoneMsg,
    ServePlanMsg,
    ServeRequestMsg,
    ServeRoundPlanMsg,
    ServeTokenMsg,
    WeightUploadMsg,
)
from repro_torch.common import ravel, unravel_like
from repro_torch.core import butterfly, clasp, compression, diloco
from repro_torch.core.pipeline import ROLE_F, compile_timetable
from repro_torch.runtime import stage_model as sm


# ---------------------------------------------------------------------------
# The training epoch
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class EpochState:
    """Mutable scratchpad one epoch's phases write into; the driver folds
    it into ``EpochStats`` at the end."""
    epoch: int
    snapshots: dict[int, dict]
    records: list = dataclasses.field(default_factory=list)
    labels_for: dict = dataclasses.field(default_factory=dict)
    stalled: int = 0
    validation: list = dataclasses.field(default_factory=list)
    batches: dict[int, int] = dataclasses.field(default_factory=dict)
    merge_quorum: bool = False
    b_eff: int = 0
    # sharing -> sync handoff: stage -> (qualifying miners, decoded uploads)
    qualified: dict[int, list] = dataclasses.field(default_factory=dict)
    uploads: dict[int, dict[int, np.ndarray]] = dataclasses.field(
        default_factory=dict)
    merged_stages: int = 0
    agreement: dict[int, np.ndarray] = dataclasses.field(default_factory=dict)


class TrainingPhase:
    name = "training"

    def run(self, swarm, state: EpochState) -> None:
        S = swarm.config
        if S.pipeline_virtual_stages != 1:
            raise NotImplementedError(
                "store-path training is stage-granular: "
                "pipeline_virtual_stages > 1 only applies to the on-mesh "
                "engine (the pipeline-engine slice)")
        tp, schema = swarm.transport, swarm.transport.schema
        for tick in range(S.inner_steps):
            batch = swarm.corpus.batch(swarm.global_tick)
            swarm.global_tick += 1
            # SWARM routing: sample one available miner per stage, reroute
            pathway = []
            ok = True
            for s in range(S.n_stages):
                avail = [m for m in swarm.stage_miners(s)
                         if swarm.available(m, tick)]
                if not avail:
                    ok = False
                    break
                pathway.append(avail[swarm.rng.randint(len(avail))])
            if not ok:
                state.stalled += 1     # a whole layer offline: pipeline stall
                continue

            tok_msg = ActivationMsg.tokens(state.epoch, tick)
            tp.publish(tok_msg, batch["tokens"], actor="orchestrator")
            # ---------------- forward chain ----------------
            in_key = tok_msg.key(schema)
            last_in_key = in_key
            for s, miner in enumerate(pathway):
                out_msg = ActivationMsg(state.epoch, tick, s, miner.uid)
                out_key = out_msg.key(schema)
                if s == S.n_stages - 1:
                    last_in_key = in_key
                out = miner.forward(tick, in_key, out_key)
                # an adversarial miner uploads a corrupted activation in
                # place of its honest output — validators catch the mismatch
                # on replay, CLASP catches the downstream loss inflation
                b = swarm.faults.behavior(miner.uid)
                if s < S.n_stages - 1 and (b.free_ride
                                           or b.tamper_activations > 0):
                    corrupted = swarm.faults.corrupt_activation(
                        miner.uid, out.float().cpu().numpy())
                    tp.publish(out_msg,
                               torch.from_numpy(corrupted).to(out.dtype),
                               actor=miner.actor)
                in_key = out_key
            last = pathway[-1]
            labels = torch.as_tensor(batch["labels"], device=swarm.device)
            state.labels_for[last_in_key] = labels

            # ---------------- backward chain ----------------
            loss, g = last.backward_last(last_in_key, labels)
            state.records.append(clasp.PathwayRecord(
                tuple(m.uid for m in pathway), loss))
            for s in range(S.n_stages - 2, -1, -1):
                miner = pathway[s]
                msg = GradientMsg(state.epoch, tick, s, miner.uid)
                if S.wire_codec == "int8":
                    # the paper's symmetric compression: gradient hand-offs
                    # ship as blockwise-int8 codes; miners train on the
                    # dequantized codes, and validator replay decodes the
                    # same payload, so both sides see one wire
                    flat = g.to(torch.float32).reshape(-1)
                    payload = dict(compression.encode(flat, "int8"),
                                   shape=tuple(g.shape))
                    tp.publish(msg, payload, actor="orchestrator")
                    g = compression.decode(payload).reshape(g.shape).to(
                        g.dtype)
                else:
                    tp.publish(msg, g, actor="orchestrator")
                g = miner.backward(miner.work_log[-1].sample_key, g)


class ValidationPhase:
    """Each validator tracks a random miner (section 3: random assignment)
    and publishes its verdict as a ``ScoreMsg`` so emissions are auditable
    from the store alone.  Only snapshotted miners are assignable.

    The epoch-start snapshots have no reader after this phase, so it
    releases them: at full width they hold 9 GB of host memory per miner,
    which the sharing and sync phases need for the uploads."""
    name = "validation"

    def run(self, swarm, state: EpochState) -> None:
        t_now = state.epoch * swarm.config.sync_interval_hours
        uids = sorted(u for u in swarm.miners if u in state.snapshots)
        if not uids:
            return
        for v in swarm.validators:
            uid = uids[swarm.rng.randint(len(uids))]
            m = swarm.miners[uid]
            res = v.validate_epoch(m, state.snapshots[uid], state.epoch,
                                   t_now, state.labels_for,
                                   max_items=swarm.config.validate_max_items)
            swarm.transport.publish(
                ScoreMsg(state.epoch, v.uid, uid),
                np.asarray([res.score, res.checked, res.passed,
                            res.min_cosine], np.float32),
                actor=v.actor)
            state.validation.append(res)
        state.snapshots.clear()


class SharingPhase:
    """Compressed sharing (section 2.1): qualifying miners (B_m >= B_min,
    quorum) upload codec-compressed weight vectors within their layer.  The
    vector is encoded on the miner's device (K2a for int8) and decoded
    there (K2b); the decoded upload comes back to numpy for the sync, as in
    the reference."""
    name = "sharing"

    def run(self, swarm, state: EpochState) -> None:
        S = swarm.config
        state.batches = {m.uid: m.batches_done
                         for m in swarm.miners.values()}
        state.b_eff = diloco.effective_batch(state.batches, S.b_min)
        state.merge_quorum = diloco.should_merge(state.batches, S.b_min,
                                                 S.quorum_frac)
        if not state.merge_quorum:
            return
        for s in range(S.n_stages):
            qual = [m for m in swarm.stage_miners(s)
                    if m.batches_done >= S.b_min]
            if len(qual) < 2:
                continue
            uploads: dict[int, np.ndarray] = {}
            with swarm.transport.parallel():   # distinct links: overlap
                for idx, m in enumerate(qual):
                    vec = m.weights_vector()
                    if swarm.faults.behavior(m.uid).tamper_weights > 0:
                        # the fault model is numpy: corrupt on the host
                        vec = torch.from_numpy(swarm.faults.corrupt_weights(
                            m.uid, vec.cpu().numpy())).to(vec.device)
                    payload = compression.encode(vec, S.share_codec)
                    del vec
                    swarm.transport.publish(
                        WeightUploadMsg(state.epoch, s, m.uid,
                                        codec=S.share_codec),
                        payload, actor=m.actor)
                    uploads[idx] = compression.decode(
                        payload).cpu().numpy()
            state.qualified[s] = qual
            state.uploads[s] = uploads


class SyncPhase:
    """Butterfly all-reduce per layer (the agreement matrix exposes
    tamperers), DiLoCo outer Nesterov step on the per-stage anchor, then
    everyone — stragglers and joiners included — downloads the anchor.  The
    dense reduce runs centrally, each shard's merge through K3 on the
    swarm's device."""
    name = "sync"

    def run(self, swarm, state: EpochState) -> None:
        if not state.merge_quorum:
            return
        for s, qual in state.qualified.items():
            merged = self._reduce_dense(swarm, state, s, qual)
            self._outer_step_and_full_sync(swarm, state, s, merged)

    def _reduce_dense(self, swarm, state: EpochState, s: int,
                      qual: list) -> np.ndarray:
        S = swarm.config
        # the decoded uploads have no reader after this stage's reduce;
        # dropping them here keeps one stage's worth on the host at a time
        uploads = state.uploads.pop(s)
        plan = butterfly.make_plan(len(qual), uploads[0].shape[0],
                                   seed=S.seed + state.epoch * 131 + s)
        # a weight-tampering miner also reduces dishonestly: its merged
        # shard copies deviate, which is what the agreement matrix exposes
        tamper = {idx: swarm.faults.behavior(m.uid).tamper_weights
                  for idx, m in enumerate(qual)
                  if swarm.faults.behavior(m.uid).tamper_weights > 0}
        copies = butterfly.reduce_with_copies(plan, uploads,
                                              tamper=tamper or None,
                                              device=swarm.device)
        state.agreement[s] = butterfly.agreement_matrix(plan, copies)
        del copies
        merged, _, _ = butterfly.reduce_shards(plan, uploads,
                                               device=swarm.device)
        return merged

    def _outer_step_and_full_sync(self, swarm, state: EpochState, s: int,
                                  merged: np.ndarray) -> None:
        S = swarm.config
        # --- DiLoCo outer step on the per-stage anchor ---
        avg = unravel_like(swarm.anchors[s],
                           torch.from_numpy(merged).to(swarm.device))
        swarm.outer[s] = diloco.outer_update(
            swarm.outer[s], avg, outer_lr=S.outer_lr,
            outer_momentum=S.outer_momentum)
        del avg
        swarm.anchors[s] = swarm.outer[s].anchor
        # --- full sync: every miner (incl. stragglers/joiners) downloads
        anchor_vec, _ = ravel(swarm.anchors[s])
        msg = AnchorMsg(state.epoch, s)
        swarm.transport.publish(msg, anchor_vec.cpu().numpy(),
                                actor="orchestrator")
        del anchor_vec
        with swarm.transport.parallel():
            for m in swarm.stage_miners(s):
                vec = swarm.transport.fetch(msg, actor=m.actor)
                m.load_weights_vector(vec)
        state.merged_stages += 1


def default_phases() -> list:
    """The reference's timeline.  Validation precedes merge because replay
    starts from the epoch-start snapshot (the miner's last full sync)."""
    return [TrainingPhase(), ValidationPhase(), SharingPhase(), SyncPhase()]


class EpochDriver:
    """Runs the phase list over a swarm and folds the scratchpad into
    ``EpochStats``."""

    def __init__(self, phases: Optional[Iterable] = None):
        self.phases: list = list(phases or default_phases())
        self._gc_floor = 0          # first epoch whose weights/scores remain

    def run_epoch(self, swarm) -> EpochStats:
        for m in swarm.miners.values():
            m.reset_epoch()
        state = EpochState(
            epoch=swarm.epoch,
            snapshots={uid: m.snapshot()
                       for uid, m in swarm.miners.items()})
        for phase in self.phases:
            phase.run(swarm, state)
        return self._finalize(swarm, state)

    def _finalize(self, swarm, state: EpochState) -> EpochStats:
        """Fold the epoch scratchpad into ``EpochStats`` and GC the store."""
        if not state.batches:
            # a timeline without SharingPhase still reports the batch census
            state.batches = {m.uid: m.batches_done
                             for m in swarm.miners.values()}
            state.b_eff = diloco.effective_batch(state.batches,
                                                 swarm.config.b_min)

        n_miners = len(swarm.miners)
        layer_of = np.array([swarm.miners[u].stage
                             for u in sorted(swarm.miners.keys())])
        report = (clasp.attribute(state.records, n_miners, layer_of)
                  if state.records else None)
        t_now = swarm.epoch * swarm.config.sync_interval_hours
        swarm.ledger.prune(t_now)
        emissions = swarm.ledger.emissions(
            t_now, miners=sorted(swarm.miners.keys()))

        stats = EpochStats(
            epoch=swarm.epoch,
            mean_loss=float(np.mean([r.loss for r in state.records]))
            if state.records else float("nan"),
            b_eff=state.b_eff,
            batches=dict(state.batches),
            merged_stages=state.merged_stages,
            stalled_ticks=state.stalled,
            agreement=state.agreement,
            clasp=report,
            validation=state.validation,
            emissions=emissions,
        )
        swarm.history.append(stats)
        swarm.epoch += 1
        # activations from this epoch are garbage-collected from the store
        schema = swarm.transport.schema
        swarm.transport.delete_prefix(
            schema.activations_prefix(stats.epoch))
        # weight/score planes: retention-window GC (None keeps everything)
        retain = swarm.config.retain_epochs
        if retain is not None:
            while self._gc_floor <= stats.epoch - retain:
                e = self._gc_floor
                swarm.transport.delete_prefix(schema.weights_prefix(e))
                swarm.transport.delete_prefix(schema.scores_prefix(e))
                self._gc_floor += 1
        return stats


# ---------------------------------------------------------------------------
# The serve plane
# ---------------------------------------------------------------------------


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
