"""Versioned store-key schema: the single place the port mints key strings
(mirrors ``repro/api/keys.py``; the serve plane of version 5).

The serve plane lives in its own ``serve/`` namespace: the driver publishes
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
byte accounting and GC prefixes match it.  The train-plane keys of
versions 1-4 come with the training slice; minting a serve key from a
schema below version 5 raises ``ValueError``, as in the reference.
"""
# this module is the one sanctioned minting site of the port's store keys
# swarmlint: disable-file=key-literal
from __future__ import annotations

import dataclasses
import re

SCHEMA_VERSION = 1
SUPPORTED_VERSIONS = (1, 2, 3, 4, 5)

NS_SERVE = "serve"

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
        """Invert a serve key back to (kind, fields); raises ValueError on
        any other key.  Numeric fields decode as ints."""
        if self.version >= 5:
            for kind, pat in _V5_PATTERNS:
                m = pat.match(key)
                if m:
                    return ParsedKey(kind, {k: int(v) for k, v in
                                            m.groupdict().items()})
        raise ValueError(f"not a serve key of KeySchema v{self.version}: "
                         f"{key!r}")
