"""CLASP — Contribution Loss Assessment via Sampling of Pathways (paper §6,

App. B).  Samples are routed through one miner per layer along
orchestrator-chosen random pathways; the orchestrator records
D = {(pathway_k, loss_k)}.  Per-miner attribution is the Shapley-style
conditional mean  l̄_i = mean{loss_k : i in pathway_k};  outliers (malicious
or broken miners) are flagged by robust z-score.

This module is pure statistics + the toy generative model of App. B; the
runtime sim feeds it *real* losses from tiny models with injected corruption
(tests/test_clasp_integration.py), reproducing Fig 8 on live training.

A copy of ``repro/core/clasp.py`` (numpy only).
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np


@dataclasses.dataclass(frozen=True)
class PathwayRecord:
    pathway: tuple[int, ...]      # miner uid per layer (one per layer)
    loss: float


@dataclasses.dataclass
class ClaspReport:
    mean_loss: np.ndarray         # (n_miners,) l̄_i  (nan if never sampled)
    counts: np.ndarray            # (n_miners,) |S_i|
    z_scores: np.ndarray          # robust z of l̄_i within each layer
    flagged: np.ndarray           # bool (n_miners,)
    layer_of: np.ndarray          # (n_miners,) layer index


def attribute(records: Sequence[PathwayRecord], n_miners: int,
              layer_of: Sequence[int], z_thresh: float = 6.0) -> ClaspReport:
    # NOTE: the default threshold is higher than the regression variant's:
    # with adversaries present, honest miners' conditional means inherit
    # co-occurrence noise (z up to ~4-5), while true adversaries land at
    # z > 20; attribute_regression controls for co-occurrence and keeps 3.0.
    """App. B: per-miner conditional mean loss + per-layer robust z-scores.

    z-scores are computed within each layer (miners in a layer see the same
    sample distribution), using median/MAD so that the malicious miners
    themselves do not drag the baseline (the paper's 'normalizing by the
    number of occurrences ... z-scores or similar').
    """
    layer_of = np.asarray(layer_of)
    sums = np.zeros(n_miners)
    counts = np.zeros(n_miners)
    for rec in records:
        for m in rec.pathway:
            sums[m] += rec.loss
            counts[m] += 1
    with np.errstate(invalid="ignore", divide="ignore"):
        mean = np.where(counts > 0, sums / np.maximum(counts, 1), np.nan)

    z = _layerwise_robust_z(mean, layer_of)
    flagged = z > z_thresh
    return ClaspReport(mean, counts, z, flagged, layer_of)


def _layerwise_robust_z(values: np.ndarray, layer_of: np.ndarray) -> np.ndarray:
    """Per-layer median-centred deviations with a scale POOLED across all

    miners: per-layer MAD over 5 miners is far too noisy (false flags), so
    the deviation scale is the global MAD of layer-centred residuals."""
    resid = np.zeros_like(values, dtype=float)
    for layer in np.unique(layer_of):
        idx = np.where(layer_of == layer)[0]
        vals = values[idx]
        ok = ~np.isnan(vals)
        if ok.sum() < 2:
            continue
        resid[idx] = np.where(ok, vals - np.median(vals[ok]), 0.0)
    ok_all = ~np.isnan(values)
    mad = np.median(np.abs(resid[ok_all])) * 1.4826
    scale = mad if mad > 1e-12 else (np.std(resid[ok_all]) + 1e-12)
    return np.where(ok_all, resid / scale, 0.0)


def attribute_regression(records: Sequence[PathwayRecord], n_miners: int,
                         layer_of: Sequence[int], z_thresh: float = 3.0,
                         ridge: float = 1e-3) -> ClaspReport:
    """Paper §6: 'treating each miner as if it were a feature in a dataset'.

    Least-squares regression loss_k ~ mu + sum_i beta_i * 1[i in pi_k]
    isolates each miner's *marginal* loss contribution, controlling for
    co-occurring bad actors — sharper than the conditional mean when
    multiple adversaries (or few samples) make pathway composition
    correlated.  beta_i replaces l̄_i in the report; z-scores as before.
    """
    layer_of = np.asarray(layer_of)
    T = len(records)
    X = np.zeros((T, n_miners + 1), np.float64)
    y = np.empty(T, np.float64)
    for k, rec in enumerate(records):
        X[k, 0] = 1.0
        for m in rec.pathway:
            X[k, 1 + m] = 1.0
        y[k] = rec.loss
    counts = X[:, 1:].sum(axis=0)
    reg = ridge * np.eye(n_miners + 1)
    beta = np.linalg.solve(X.T @ X + reg, X.T @ y)
    contrib = np.where(counts > 0, beta[1:], np.nan)

    z = _layerwise_robust_z(contrib, layer_of)
    return ClaspReport(contrib, counts, z, z > z_thresh, layer_of)


# ---------------------------------------------------------------------------
# Pathway sampling (orchestrator side)
# ---------------------------------------------------------------------------


def sample_pathways(rng: np.random.RandomState, miners_per_layer: Sequence[Sequence[int]],
                    n_samples: int) -> list[tuple[int, ...]]:
    """Uniform random routes, one miner per layer (paper App. B item 2)."""
    out = []
    for _ in range(n_samples):
        out.append(tuple(int(rng.choice(layer)) for layer in miners_per_layer))
    return out


# ---------------------------------------------------------------------------
# Toy generative model (paper App. B / Fig 8)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ToyConfig:
    n_layers: int = 5
    miners_per_layer: int = 5
    base_loss: float = 4.5
    base_std: float = 0.2
    malicious_inflation: float = 0.10   # +10% loss and std per bad miner hit
    n_samples: int = 5000
    seed: int = 0


def toy_simulation(cfg: ToyConfig, malicious: Sequence[int]
                   ) -> tuple[list[PathwayRecord], np.ndarray]:
    """Generate (records, layer_of) under the paper's toy model: loss ~

    N(4.5, 0.2); a malicious miner on the path inflates mean and std 10%."""
    rng = np.random.RandomState(cfg.seed)
    n_miners = cfg.n_layers * cfg.miners_per_layer
    layer_of = np.repeat(np.arange(cfg.n_layers), cfg.miners_per_layer)
    layers = [list(range(l * cfg.miners_per_layer, (l + 1) * cfg.miners_per_layer))
              for l in range(cfg.n_layers)]
    bad = set(malicious)
    records = []
    for path in sample_pathways(rng, layers, cfg.n_samples):
        n_bad = sum(1 for m in path if m in bad)
        mu = cfg.base_loss * (1 + cfg.malicious_inflation) ** n_bad
        sd = cfg.base_std * (1 + cfg.malicious_inflation) ** n_bad
        records.append(PathwayRecord(path, float(rng.normal(mu, sd))))
    return records, layer_of


def fair_miner_suppression(report: ClaspReport, malicious: Sequence[int]) -> float:
    """Fig 8b's 'intrinsic balancing': fair miners sharing a layer with bad

    actors show *reduced* contribution (they are sampled into fewer bad
    paths than the bad miner, so their conditional mean sits below the
    overall mean).  Returns mean(l̄ fair-in-bad-layer) - mean(l̄ fair-in-clean
    -layer); negative = suppression observed."""
    bad = set(malicious)
    bad_layers = {report.layer_of[m] for m in bad}
    fair = [m for m in range(len(report.mean_loss)) if m not in bad]
    in_bad = [report.mean_loss[m] for m in fair if report.layer_of[m] in bad_layers]
    in_clean = [report.mean_loss[m] for m in fair
                if report.layer_of[m] not in bad_layers]
    if not in_bad or not in_clean:
        return 0.0
    return float(np.nanmean(in_bad) - np.nanmean(in_clean))
