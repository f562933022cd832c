"""Deterministic data pipeline: FineWeb-like synthetic corpus + host sharding
(a copy of ``repro/data/pipeline.py``; numpy only, so batches equal the
reference's byte for byte).

Offline container => no real FineWeb.  ``SyntheticCorpus`` generates a
*learnable* token stream (a hidden per-document Markov structure over the
vocab plus repeated motifs), so convergence benchmarks show real loss
decreases; it is seeded, shardable by (host, epoch, step), and cheap.

In IOTA, layer-0 miners own data ingestion + tokenization (paper §2.2):
``make_host_iterator(host_id, n_hosts, ...)`` hands each first-layer miner a
disjoint shard by folding host_id into the stream seed, exactly how the
runtime sim wires it.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np

from repro_torch.common import stable_hash


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    batch_size: int
    seed: int = 0
    n_motifs: int = 64           # repeated phrases -> learnable structure
    motif_len: int = 8
    markov_order: int = 1
    doc_len: int = 512


class SyntheticCorpus:
    """Hidden-structure synthetic token stream.

    Each document draws a topic t; tokens follow a topic-conditioned bigram
    chain interleaved with exact motif repetitions.  An LM that learns the
    motifs + chain reaches substantially-below-uniform loss — enough signal
    for the paper's convergence comparisons (Fig 5 reproduction) without
    real data.
    """

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        rng = np.random.RandomState(cfg.seed)
        V = cfg.vocab_size
        self.motifs = rng.randint(3, V, size=(cfg.n_motifs, cfg.motif_len))
        # low-rank bigram logits: token -> distribution over next tokens
        rank = 16
        self._emb_in = rng.randn(V, rank).astype(np.float32) * 0.7
        self._emb_out = rng.randn(rank, V).astype(np.float32) * 0.7
        self._topic_shift = rng.randn(8, rank).astype(np.float32)

    def _doc(self, rng: np.random.RandomState) -> np.ndarray:
        cfg = self.cfg
        V = cfg.vocab_size
        topic = rng.randint(len(self._topic_shift))
        out = np.empty(cfg.doc_len, np.int64)
        tok = rng.randint(3, V)
        i = 0
        while i < cfg.doc_len:
            if rng.rand() < 0.15:                       # motif insertion
                m = self.motifs[rng.randint(cfg.n_motifs)]
                n = min(len(m), cfg.doc_len - i)
                out[i:i + n] = m[:n]
                i += n
                tok = int(out[i - 1])
                continue
            logits = (self._emb_in[tok] + 0.5 * self._topic_shift[topic]
                      ) @ self._emb_out
            # top-64 sampling keeps the chain predictable
            top = np.argpartition(logits, -64)[-64:]
            p = np.exp(logits[top] - logits[top].max())
            p /= p.sum()
            tok = int(top[rng.choice(len(top), p=p)])
            out[i] = tok
            i += 1
        return out

    def batch(self, step: int, host_id: int = 0, n_hosts: int = 1) -> dict:
        """Deterministic (host, step)-addressed batch: {tokens, labels}."""
        cfg = self.cfg
        rng = np.random.RandomState(
            stable_hash(cfg.seed, "batch", host_id, n_hosts, step) % (2**31))
        need = cfg.batch_size * (cfg.seq_len + 1)
        stream = []
        while sum(len(d) for d in stream) < need:
            stream.append(self._doc(rng))
        flat = np.concatenate(stream)[:need].reshape(
            cfg.batch_size, cfg.seq_len + 1).astype(np.int32)
        return {"tokens": flat[:, :-1], "labels": flat[:, 1:]}


def make_host_iterator(cfg: DataConfig, host_id: int = 0, n_hosts: int = 1,
                       start_step: int = 0) -> Iterator[dict]:
    """Resumable per-host iterator (checkpoint stores the step cursor)."""
    corpus = SyntheticCorpus(cfg)
    step = start_step
    while True:
        yield corpus.batch(step, host_id, n_hosts)
        step += 1
