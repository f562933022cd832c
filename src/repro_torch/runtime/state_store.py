"""The shared store (paper §2 'S3 bucket'), in process (mirrors
``repro/runtime/state_store.py``).

A dict with content digests and byte accounting per (namespace, direction)
and per actor, and the optional wire codec applied on put (compressed
sharing).  Payloads are host data: nests of dicts, lists and tuples whose
leaves are CPU tensors (bf16 has no numpy dtype), numpy arrays or Python
scalars.  ``put`` copies a tensor leaf that lies on the card to the host,
so what the store keeps never holds device memory (a full-width epoch puts
~17 GB of last-stage logits into it).  A tensor leaf counts its raw bytes
and any other leaf counts ``np.asarray(leaf).nbytes``, so the byte counts
equal the reference's for the same payloads.
"""
from __future__ import annotations

import dataclasses
import hashlib
from collections import defaultdict
from typing import Any, Iterator, Optional

import numpy as np
import torch

from repro_torch.common import ravel, tree_map
from repro_torch.core import compression


class StoreKeyError(KeyError):
    """Missing store key, with the key, who asked, and the nearest prefix
    that does exist."""

    def __init__(self, key: str, actor: str = "?",
                 nearest_prefix: str = "", nearest_count: int = 0):
        self.key = key
        self.actor = actor
        self.nearest_prefix = nearest_prefix
        self.nearest_count = nearest_count
        if nearest_prefix:
            hint = (f"nearest existing prefix {nearest_prefix!r} "
                    f"({nearest_count} keys)")
        else:
            hint = "store is empty" if nearest_count == 0 else \
                f"no shared prefix ({nearest_count} keys in store)"
        super().__init__(
            f"store key not found: {key!r} (requested by {actor!r}; {hint})")

    def __str__(self) -> str:  # KeyError.__str__ repr()s the arg; undo that
        return self.args[0]


@dataclasses.dataclass
class StoreEntry:
    payload: Any
    nbytes: int
    digest: str
    meta: dict


def _leaves(value: Any) -> Iterator[Any]:
    """Leaves in the reference's pytree order: dict values by sorted key,
    list and tuple items in order, ``None`` holds no leaf."""
    if isinstance(value, dict):
        for k in sorted(value):
            yield from _leaves(value[k])
    elif isinstance(value, (list, tuple)):
        for v in value:
            yield from _leaves(v)
    elif value is not None:
        yield value


def _leaf_bytes(leaf: Any) -> np.ndarray:
    """The leaf's raw bytes as a contiguous array (hashed without a copy)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        return t.reshape(-1).view(torch.uint8).numpy()
    return np.ascontiguousarray(np.asarray(leaf)).reshape(-1).view(np.uint8)


def _host(value: Any) -> Any:
    """``value`` with every tensor leaf on the host."""
    if isinstance(value, dict):
        return {k: _host(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return type(value)(_host(v) for v in value)
    if isinstance(value, torch.Tensor):
        return value.detach().cpu()
    return value


def _nbytes(value: Any) -> int:
    total = 0
    for leaf in _leaves(value):
        if isinstance(leaf, torch.Tensor):
            total += leaf.numel() * leaf.element_size()
        else:
            total += np.asarray(leaf).nbytes
    return total


def _digest(value: Any) -> str:
    h = hashlib.blake2b(digest_size=12)
    for leaf in _leaves(value):
        h.update(_leaf_bytes(leaf))
    return h.hexdigest()


class StateStore:
    def __init__(self):
        self._data: dict[str, StoreEntry] = {}
        self.uploaded = defaultdict(int)      # namespace -> bytes
        self.downloaded = defaultdict(int)
        self.uploads_by_actor = defaultdict(int)
        self.downloads_by_actor = defaultdict(int)

    @staticmethod
    def _ns(key: str) -> str:
        return key.split("/", 1)[0]

    @staticmethod
    def _under(key: str, prefix: str) -> bool:
        """Segment-boundary prefix match: ``a/ep1`` covers ``a/ep1/...``
        and the exact key, not ``a/ep10/...``; a trailing ``/`` keeps its
        literal meaning; the empty prefix covers everything."""
        if not prefix:
            return True
        if prefix.endswith("/"):
            return key.startswith(prefix)
        return key == prefix or key.startswith(prefix + "/")

    def put(self, key: str, value: Any, actor: str = "?",
            codec: Optional[str] = None,
            meta: Optional[dict] = None) -> StoreEntry:
        """Store ``value`` (tensor leaves copied to the host) and return its
        entry (payload, bytes, digest).  With a ``codec``, the value is
        flattened and stored as that codec's payload."""
        if codec and codec != "none":
            flat, _ = ravel(tree_map(torch.as_tensor, value))
            value = compression.encode(flat, codec)
        value = _host(value)
        nbytes = _nbytes(value)
        entry = StoreEntry(value, nbytes, _digest(value),
                           dict(meta or {}, codec=codec or "none"))
        self._data[key] = entry
        self.uploaded[self._ns(key)] += nbytes
        self.uploads_by_actor[actor] += nbytes
        return entry

    def _nearest_prefix(self, key: str) -> tuple[str, int]:
        """Longest '/'-segment prefix of ``key`` under which keys exist."""
        parts = key.split("/")
        for i in range(len(parts), 0, -1):
            p = "/".join(parts[:i])
            n = sum(1 for k in self._data if self._under(k, p))
            if n:
                return p, n
        return "", len(self._data)

    def _missing(self, key: str, actor: str) -> StoreKeyError:
        prefix, count = self._nearest_prefix(key)
        return StoreKeyError(key, actor, prefix, count)

    def get(self, key: str, actor: str = "?") -> Any:
        return self.fetch_entry(key, actor).payload

    def fetch_entry(self, key: str, actor: str = "?") -> StoreEntry:
        """Accounted read returning the full entry."""
        entry = self._data.get(key)
        if entry is None:
            raise self._missing(key, actor)
        self.downloaded[self._ns(key)] += entry.nbytes
        self.downloads_by_actor[actor] += entry.nbytes
        return entry

    def exists(self, key: str) -> bool:
        return key in self._data

    def delete_prefix(self, prefix: str) -> int:
        doomed = [k for k in self._data if self._under(k, prefix)]
        for k in doomed:
            del self._data[k]
        return len(doomed)

    def keys(self, prefix: str = "") -> list[str]:
        return sorted(k for k in self._data if self._under(k, prefix))

    def traffic_report(self) -> dict:
        return {
            "uploaded": dict(self.uploaded),
            "downloaded": dict(self.downloaded),
            "by_actor_up": dict(self.uploads_by_actor),
            "by_actor_down": dict(self.downloads_by_actor),
            "total_bytes": (sum(self.uploaded.values())
                            + sum(self.downloaded.values())),
        }
