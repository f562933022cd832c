"""The slice gate: the port's in-process swarm epoch against a live JAX run.

A live JAX ``Swarm.create(mcfg(6), SwarmConfig(seed=0)).run(3)`` (3 stages
x 3 miners, smoke llama3.2-1b) and the port's ``Swarm.create(...,
device="cpu")`` started from the JAX swarm's anchors
(``repro_torch.convert.load_swarm_state``), run for 3 epochs.  The pinned
seed constants of ``tests/test_api.py`` do not match the reference on this
JAX version, so the port is held to a live run, never to them.

Identical: every tick's pathway (the CLASP records' miner uids), ``batches``,
``b_eff``, ``merged_stages``, ``stalled_ticks``, the validators' tracked
miners with their ``checked``/``passed`` counts, the emission ranking, and
the agreement matrices.

Within a bar: stage activations run in bf16 and the two frameworks round
bf16 intermediates at different places, so losses differ by ~1e-4 (~2e-5
relative): each tick's loss and each epoch's ``mean_loss`` within
``LOSS_ATOL`` = 1e-3.  The final anchors: the int8 sharing codec rounds
every weight to its 256-block's step amax/127, and a weight that bf16
noise moved across a rounding boundary lands one step away in one miner's
upload; the merge halves that and the outer Nesterov step scales it by
outer_lr * (1 + momentum) = 1.33 (first merge), so an anchor element may
differ by up to ``ANCHOR_STEPS`` = 1.33 steps of its block (at most
1.33 * 2.0 / 127 here), plus 1e-5 for scales that bf16 noise moved.  Such
gaps are rare (under 2% of elements half a step or more apart; 0.8%
observed), and the anchors agree within ``ANCHOR_REL`` = 1e-3 in L2 norm
(2.5e-4 observed).
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from repro.api import Swarm as JSwarm
from repro.api import SwarmConfig as JSwarmConfig
from repro.api.phases import SharingPhase as JSharing
from repro.api.phases import SyncPhase as JSync
from repro.api.phases import TrainingPhase as JTraining
from repro.api.phases import ValidationPhase as JValidation
from repro.configs import get as jget
from repro.configs import smoke_variant as jsmoke
from repro.runtime.network import FaultModel as JFaultModel
from repro.runtime.network import MinerBehavior as JMinerBehavior
from repro_torch import configs
from repro_torch.api.config import SwarmConfig
from repro_torch.api.phases import (
    SharingPhase,
    SyncPhase,
    TrainingPhase,
    ValidationPhase,
)
from repro_torch.api.swarm import Swarm
from repro_torch.common import ravel
from repro_torch.convert import load_swarm_state
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import quant_stream as qs
from repro_torch.kernels import shard_merge as smk
from repro_torch.runtime.network import FaultModel, MinerBehavior

LOSS_ATOL = 1e-3
ANCHOR_STEPS = 0.7 * (1 + 0.9)
ANCHOR_ATOL = 1e-5
ANCHOR_REL = 1e-3


def _mcfgs(n_layers=6):
    j = dataclasses.replace(jsmoke(jget("llama3.2-1b")).model,
                            n_layers=n_layers)
    t = dataclasses.replace(configs.smoke_variant(
        configs.get("llama3.2-1b")).model, n_layers=n_layers)
    return j, t


def _recording(training_cls, log):
    """A TrainingPhase that also logs each epoch's (pathway, loss) list."""
    class Recording(training_cls):
        def run(self, swarm, state):
            super().run(swarm, state)
            log.append([(r.pathway, r.loss) for r in state.records])
    return Recording()


def _run_both(n_epochs, faults=None, **cfg):
    """The same swarm in both packages from the JAX swarm's anchors."""
    jcfg, tcfg = _mcfgs()
    jlog, tlog = [], []
    jswarm = JSwarm.create(
        jcfg, JSwarmConfig(seed=0, **cfg),
        faults=JFaultModel({u: JMinerBehavior(**b)
                            for u, b in (faults or {}).items()}, seed=0),
        phases=[_recording(JTraining, jlog), JValidation(), JSharing(),
                JSync()])
    anchors = [jax.tree.map(np.asarray, a) for a in jswarm.anchors]
    tswarm = Swarm.create(
        tcfg, SwarmConfig(seed=0, **cfg),
        faults=FaultModel({u: MinerBehavior(**b)
                           for u, b in (faults or {}).items()}, seed=0),
        phases=[_recording(TrainingPhase, tlog), ValidationPhase(),
                SharingPhase(), SyncPhase()],
        device="cpu")
    load_swarm_state(tswarm, anchors)
    before = (dict(fa.LAUNCHES), dict(smk.LAUNCHES), dict(qs.LAUNCHES))
    jstats, tstats = jswarm.run(n_epochs), tswarm.run(n_epochs)
    # on the CPU every kernel wrapper takes its plain version
    assert (fa.LAUNCHES, smk.LAUNCHES, qs.LAUNCHES) == before
    return (jswarm, jstats, jlog), (tswarm, tstats, tlog)


def _census(stats):
    return [dict(batches=s.batches, b_eff=s.b_eff,
                 merged=s.merged_stages, stalled=s.stalled_ticks,
                 validation=[(r.miner_uid, r.checked, r.passed)
                             for r in s.validation],
                 emission_rank=sorted(s.emissions,
                                      key=lambda u: (-s.emissions[u], u)),
                 agreement={k: v.tolist() for k, v in s.agreement.items()})
            for s in stats]


@pytest.fixture(scope="module")
def default_run():
    return _run_both(3)


def test_pathways_and_tick_losses(default_run):
    (_, _, jlog), (_, _, tlog) = default_run
    assert len(jlog) == len(tlog) == 3
    for je, te in zip(jlog, tlog):
        assert [p for p, _ in te] == [p for p, _ in je]
        np.testing.assert_allclose([l for _, l in te], [l for _, l in je],
                                   rtol=0, atol=LOSS_ATOL)


def test_census_is_identical(default_run):
    (_, jstats, _), (_, tstats, _) = default_run
    assert _census(tstats) == _census(jstats)
    assert sum(s.merged_stages for s in tstats) >= 1
    for s in tstats:
        assert all(r.passed == r.checked for r in s.validation)


def test_mean_loss_within_bar(default_run):
    (_, jstats, _), (_, tstats, _) = default_run
    for j, t in zip(jstats, tstats):
        assert np.isfinite(t.mean_loss)
        assert abs(t.mean_loss - j.mean_loss) <= LOSS_ATOL


def test_final_anchors_within_bar(default_run):
    (jswarm, _, _), (tswarm, _, _) = default_run
    for ja, ta in zip(jswarm.anchors, tswarm.anchors):
        want = np.asarray(ravel_pytree(ja)[0], np.float32)
        got = ravel(ta)[0].numpy()
        n = want.size
        pad = (-n) % 256
        amax = np.abs(np.pad(want, (0, pad))).reshape(-1, 256).max(axis=1)
        step = np.repeat(amax / 127.0, 256)[:n]
        err = np.abs(got - want)
        assert np.all(err <= ANCHOR_STEPS * step + ANCHOR_ATOL)
        # a step-sized gap is the exception: few elements sit half a step
        # or more apart, and the vectors agree to ANCHOR_REL in norm
        assert np.mean(err >= 0.5 * step) < 0.02
        assert np.linalg.norm(got - want) <= ANCHOR_REL * np.linalg.norm(
            want)


def test_int8_gradient_wire_one_epoch():
    (_, jstats, jlog), (_, tstats, tlog) = _run_both(1, wire_codec="int8")
    assert _census(tstats) == _census(jstats)
    assert [p for p, _ in tlog[0]] == [p for p, _ in jlog[0]]
    assert abs(tstats[0].mean_loss - jstats[0].mean_loss) <= LOSS_ATOL


def test_free_rider_gets_the_same_verdict():
    """Miner 0 (stage 0) free-rides: it uploads zeros in place of its
    activations.  With three validators the third tracks it (the
    validators' choices are the swarm RNG's, equal in both packages), and
    both packages reject every item it did."""
    (_, jstats, _), (_, tstats, _) = _run_both(
        1, faults={0: dict(free_ride=True)}, validators=3)
    assert _census(tstats) == _census(jstats)
    verdict = {r.miner_uid: (r.checked, r.passed) for r in
               tstats[0].validation}
    checked, passed = verdict[0]
    assert checked > 0 and passed == 0
    jv = {r.miner_uid: r.min_cosine for r in jstats[0].validation}
    tv = {r.miner_uid: r.min_cosine for r in tstats[0].validation}
    assert abs(tv[0] - jv[0]) <= 1e-6


def test_create_without_device_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, tcfg = _mcfgs()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Swarm.create(tcfg, SwarmConfig(seed=0))


def test_unported_knobs_name_their_slice():
    _, tcfg = _mcfgs()
    with pytest.raises(NotImplementedError, match="sharded-sync slice"):
        SwarmConfig(sync_mode="sharded")
    with pytest.raises(NotImplementedError, match="multi-process slice"):
        Swarm.create(tcfg, SwarmConfig(seed=0), runtime="actors",
                     device="cpu")
