"""Versioned store-key schema: the single place the port mints key strings
(mirrors ``repro/api/keys.py``: the train plane of version 1 and the serve
plane of version 5).

Version 1, the lockstep training epoch:

  activations/ep{E}/t{T}/tokens          pipeline-entry token batch
  activations/ep{E}/t{T}/s{S}/m{U}       stage-S output uploaded by miner U
  activations/ep{E}/t{T}/s{S}/m{U}/grad  gradient w.r.t. that output
  weights/ep{E}/s{S}/m{U}                compressed weight upload (sharing)
  weights/ep{E}/s{S}/merged              post-butterfly DiLoCo anchor
  scores/ep{E}/v{V}/m{U}                 validator V's score for miner U

Version 5: the serve plane lives in its own ``serve/`` namespace: the driver publishes
the session plan once, then one lane plan per decode round; stages
store-and-forward boundary codes per (round, lane); tokens append under
their request:

  serve/plan                        serve session spec (stages, lanes, codec)
  serve/round{N}/plan               round N's lane plan (admission/retire)
  serve/round{N}/l{L}/s{S}          stage S's boundary output for lane L
  serve/req{R}                      request R's prompt envelope
  serve/req{R}/tok{T}               token T emitted for request R
  serve/req{R}/done                 completion marker (latency stats)

Every string equals the reference's byte for byte, so digests, namespace
byte accounting and GC prefixes match it.  Minting a serve key from a
schema below version 5 raises ``ValueError``, as in the reference.  The
kinds versions 2-4 add (shard keys of the sharded sync, the actor runtime's
control plane, plan revisions) come with later slices.
"""
# this module is the one sanctioned minting site of the port's store keys
# swarmlint: disable-file=key-literal
from __future__ import annotations

import dataclasses
import re

SCHEMA_VERSION = 1
SUPPORTED_VERSIONS = (1, 2, 3, 4, 5)

NS_ACTIVATIONS = "activations"
NS_WEIGHTS = "weights"
NS_SCORES = "scores"
NS_SERVE = "serve"

_V1_PATTERNS = (
    ("tokens", re.compile(
        r"^activations/ep(?P<epoch>\d+)/t(?P<tick>\d+)/tokens$")),
    ("gradient", re.compile(
        r"^activations/ep(?P<epoch>\d+)/t(?P<tick>\d+)/s(?P<stage>\d+)"
        r"/m(?P<uid>\d+)/grad$")),
    ("activation", re.compile(
        r"^activations/ep(?P<epoch>\d+)/t(?P<tick>\d+)/s(?P<stage>\d+)"
        r"/m(?P<uid>\d+)$")),
    ("anchor", re.compile(
        r"^weights/ep(?P<epoch>\d+)/s(?P<stage>\d+)/merged$")),
    ("weights", re.compile(
        r"^weights/ep(?P<epoch>\d+)/s(?P<stage>\d+)/m(?P<uid>\d+)$")),
    ("score", re.compile(
        r"^scores/ep(?P<epoch>\d+)/v(?P<validator>\d+)/m(?P<uid>\d+)$")),
)

_V5_PATTERNS = (
    ("serve_plan", re.compile(r"^serve/plan$")),
    ("serve_round_plan", re.compile(r"^serve/round(?P<round>\d+)/plan$")),
    ("serve_code", re.compile(
        r"^serve/round(?P<round>\d+)/l(?P<lane>\d+)/s(?P<stage>\d+)$")),
    ("serve_token", re.compile(
        r"^serve/req(?P<req>\d+)/tok(?P<index>\d+)$")),
    ("serve_done", re.compile(r"^serve/req(?P<req>\d+)/done$")),
    ("serve_request", re.compile(r"^serve/req(?P<req>\d+)$")),
)


@dataclasses.dataclass(frozen=True)
class ParsedKey:
    kind: str
    fields: dict


@dataclasses.dataclass(frozen=True)
class KeySchema:
    version: int = SCHEMA_VERSION

    def __post_init__(self):
        if self.version not in SUPPORTED_VERSIONS:
            raise ValueError(
                f"unsupported KeySchema version {self.version}; "
                f"supported: {SUPPORTED_VERSIONS}")

    # -- activation plane (v1) -------------------------------------------

    def tokens(self, epoch: int, tick: int) -> str:
        return f"activations/ep{epoch}/t{tick}/tokens"

    def activation(self, epoch: int, tick: int, stage: int, uid: int) -> str:
        return f"activations/ep{epoch}/t{tick}/s{stage}/m{uid}"

    def gradient(self, epoch: int, tick: int, stage: int, uid: int) -> str:
        return self.activation(epoch, tick, stage, uid) + "/grad"

    def gradient_for(self, activation_key: str) -> str:
        """Gradient key paired with an already-minted activation key
        (validator replay walks the miner's work log, which stores keys)."""
        return activation_key + "/grad"

    # -- weight and score planes (v1) -----------------------------------

    def weight_upload(self, epoch: int, stage: int, uid: int) -> str:
        return f"weights/ep{epoch}/s{stage}/m{uid}"

    def anchor(self, epoch: int, stage: int) -> str:
        return f"weights/ep{epoch}/s{stage}/merged"

    def score(self, epoch: int, validator_uid: int, miner_uid: int) -> str:
        return f"scores/ep{epoch}/v{validator_uid}/m{miner_uid}"

    # -- prefixes the epoch driver GCs (v1) ------------------------------

    def activations_prefix(self, epoch: int) -> str:
        return f"activations/ep{epoch}"

    def weights_prefix(self, epoch: int) -> str:
        return f"weights/ep{epoch}"

    def scores_prefix(self, epoch: int) -> str:
        """All score keys of one epoch (the retention-window GC)."""
        return f"scores/ep{epoch}"

    # -- serve plane (v5) ------------------------------------------------

    def _require_v5(self, kind: str) -> None:
        if self.version < 5:
            raise ValueError(
                f"{kind} keys need KeySchema version >= 5 "
                f"(this schema is v{self.version}); serve fleets construct "
                f"their transport with KeySchema(version=5)")

    def serve_plan(self) -> str:
        """The serve session spec (stage count, lane count, wire codec)."""
        self._require_v5("serve_plan")
        return "serve/plan"

    def serve_round_plan(self, round_: int) -> str:
        """Round ``round_``'s lane plan: which request occupies each lane
        and whether its slot is a prefill or a decode step."""
        self._require_v5("serve_round_plan")
        return f"serve/round{round_}/plan"

    def serve_code(self, round_: int, lane: int, stage: int) -> str:
        """Stage ``stage``'s boundary output for ``lane`` in one round —
        a wire code mid-chain, last-token logits on the final stage."""
        self._require_v5("serve_code")
        return f"serve/round{round_}/l{lane}/s{stage}"

    def serve_request(self, req: int) -> str:
        """Request ``req``'s prompt envelope (tokens + sampling params)."""
        self._require_v5("serve_request")
        return f"serve/req{req}"

    def serve_token(self, req: int, index: int) -> str:
        """Token ``index`` emitted for request ``req`` (0 = first sampled
        token, i.e. the prefill's continuation)."""
        self._require_v5("serve_token")
        return f"serve/req{req}/tok{index}"

    def serve_done(self, req: int) -> str:
        """Completion marker for request ``req`` (latency stats payload)."""
        self._require_v5("serve_done")
        return f"serve/req{req}/done"

    def serve_round_prefix(self, round_: int) -> str:
        """All boundary codes + the lane plan of one decode round — the
        serve driver GCs rounds as lanes drain them."""
        self._require_v5("serve_round_prefix")
        return f"serve/round{round_}"

    def serve_request_prefix(self, req: int) -> str:
        """Everything a finished request left behind (envelope, tokens,
        done marker)."""
        self._require_v5("serve_request_prefix")
        return f"serve/req{req}"

    def parse(self, key: str) -> ParsedKey:
        """Invert a v1 or serve key back to (kind, fields); raises
        ValueError on any other key (serve keys need v5).  Numeric fields
        decode as ints."""
        patterns = (_V5_PATTERNS if self.version >= 5 else ()) + _V1_PATTERNS
        for kind, pat in patterns:
            m = pat.match(key)
            if m:
                return ParsedKey(kind, {k: int(v) for k, v in
                                        m.groupdict().items()})
        raise ValueError(f"key does not match KeySchema v{self.version}: "
                         f"{key!r}")
