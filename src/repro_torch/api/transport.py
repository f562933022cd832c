"""How messages reach the shared store (mirrors ``repro/api/transport.py``).

The serve slice carries the in-process transport: a zero-latency wrapper
over ``StateStore`` with the reference's byte accounting, implementing the
whole surface of the reference's ``Transport`` protocol.  The socket store
and actor fleets come with the multi-process slice.
"""
from __future__ import annotations

import contextlib
from typing import Any, Optional

from repro_torch.api.keys import KeySchema
from repro_torch.api.messages import Message
from repro_torch.runtime.state_store import (  # noqa: F401
    StateStore, StoreKeyError,
)


class InProcessTransport:
    """A dict lookup away: no latency, no bandwidth."""

    def __init__(self, store: Optional[StateStore] = None,
                 schema: Optional[KeySchema] = None):
        self.store = store or StateStore()
        self.schema = schema or KeySchema()

    # -- typed plane -----------------------------------------------------

    def publish(self, msg: Message, payload: Any, actor: str = "?",
                meta: Optional[dict] = None) -> str:
        return self.put(msg.key(self.schema), payload, actor=actor, meta=meta)

    def fetch(self, msg: Message, actor: str = "?") -> Any:
        return self.get(msg.key(self.schema), actor=actor)

    # -- raw plane -------------------------------------------------------

    def put(self, key: str, value: Any, actor: str = "?",
            codec: Optional[str] = None,
            meta: Optional[dict] = None) -> str:
        return self.store.put(key, value, actor=actor, codec=codec,
                              meta=meta).digest

    def get(self, key: str, actor: str = "?") -> Any:
        return self.store.get(key, actor=actor)

    def exists(self, key: str) -> bool:
        return self.store.exists(key)

    def delete_prefix(self, prefix: str) -> int:
        return self.store.delete_prefix(prefix)

    def keys(self, prefix: str = "") -> list[str]:
        return self.store.keys(prefix)

    # -- timing ----------------------------------------------------------

    @contextlib.contextmanager
    def parallel(self):
        yield

    def traffic_report(self) -> dict:
        return self.store.traffic_report()

    def link_report(self) -> dict:
        return {}

    def elapsed_seconds(self) -> float:
        return 0.0
