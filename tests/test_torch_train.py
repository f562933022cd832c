"""The training slice's modules against the JAX package, on the CPU.

  * ``SyntheticCorpus`` batches equal the reference's byte for byte;
  * the flattened weight vector of imported parameters equals
    ``ravel_pytree``'s bit for bit (the layout sharing, the butterfly plan
    and the int8 blocks all cut);
  * each stage role's forward, recompute-forward VJP and last-stage
    loss/grads on imported parameters match JAX's;
  * AdamW with the cosine-warmup schedule, the DiLoCo outer step, the
    butterfly plan, reduce and agreement matrix, and the v1 store keys
    match the reference's.

Tolerances.  Stage functions run their activations in bf16, and XLA and
PyTorch round bf16 intermediates at different places (XLA fuses
elementwise chains in f32): stage outputs and input gradients agree within
``BF16_REL`` = 2**-5 of their largest magnitude, every parameter-gradient
leaf with more than one element within ``BF16_REL`` of its own largest
magnitude, and the whole flattened gradient has cosine >= 0.999 with
JAX's.  The gate ``alpha_dec`` scales the bf16 stage entry z @ w_up; its
gradient is one bf16-rounded sum of B * S * d_model products that largely
cancel (it can be 1/1000 of its terms' magnitude), so it is held within
``BF16_REL`` of the magnitude of those terms, which the w_up gradient
gives: sum |w_up * dL/dw_up| / |alpha_dec|.  The loss (~6.3)
agrees within ``LOSS_ATOL`` = 1e-3: its logits come from bf16 activations
(observed differences ~2e-4).  The optimizer and outer step run in f32 on the same numbers:
within 1e-6 relative (``pow``/``cos``/``sqrt`` may differ by an ulp).  The
plan and keys are equal; the butterfly's merged vectors within one f32 ulp.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from repro import configs as jconfigs
from repro.api.keys import KeySchema as JKeySchema
from repro.core import butterfly as jbf
from repro.core import diloco as jdiloco
from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import SyntheticCorpus as JCorpus
from repro.optim import adamw as jadamw
from repro.optim.schedules import cosine_warmup as jcosine
from repro.runtime import stage_model as jsm
from repro_torch import configs
from repro_torch.api.keys import KeySchema
from repro_torch.api.messages import (
    ActivationMsg,
    AnchorMsg,
    GradientMsg,
    ScoreMsg,
    WeightUploadMsg,
)
from repro_torch.common import cosine_similarity, ravel, tree_leaves
from repro_torch.convert import stage_params_from_numpy
from repro_torch.core import butterfly, diloco
from repro_torch.data.pipeline import DataConfig, SyntheticCorpus
from repro_torch.optim import adamw
from repro_torch.optim.schedules import cosine_warmup
from repro_torch.runtime import stage_model as sm

BF16_REL = 2.0 ** -5
LOSS_ATOL = 1e-3
OPT_TOL = dict(rtol=1e-6, atol=1e-7)
ULP_TOL = dict(rtol=2.0 ** -23, atol=0.0)
ROLES = ["first", "mid", "last"]


def _specs():
    jc = dataclasses.replace(
        jconfigs.smoke_variant(jconfigs.get("llama3.2-1b")).model, n_layers=6)
    tc = dataclasses.replace(
        configs.smoke_variant(configs.get("llama3.2-1b")).model, n_layers=6)
    return jsm.SwarmModelSpec(jc, 3), sm.SwarmModelSpec(tc, 3)


def _params(stage: int):
    jspec, tspec = _specs()
    jp = jsm.init_stage_params(jax.random.fold_in(jax.random.key(0), stage),
                               jspec, stage)
    return jp, stage_params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _close_rel(got, want, rel):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, f"max error {err} > {rel} * {scale}"


def test_corpus_batches_byte_equal():
    for vocab, seq, batch in [(512, 32, 4), (128256, 64, 2)]:
        j = JCorpus(JDataConfig(vocab_size=vocab, seq_len=seq,
                                batch_size=batch, seed=3))
        t = SyntheticCorpus(DataConfig(vocab_size=vocab, seq_len=seq,
                                       batch_size=batch, seed=3))
        for step in (0, 7):
            a, b = j.batch(step), t.batch(step)
            for k in ("tokens", "labels"):
                assert a[k].dtype == b[k].dtype
                assert a[k].tobytes() == b[k].tobytes()


@pytest.mark.parametrize("stage", [0, 1, 2], ids=ROLES)
def test_weight_vector_layout_equals_ravel_pytree(stage):
    jp, tp = _params(stage)
    jvec, _ = ravel_pytree(jax.tree.map(lambda x: x.astype(jnp.float32), jp))
    tvec, unravel = ravel(tp)
    np.testing.assert_array_equal(tvec.numpy().view(np.uint32),
                                  np.asarray(jvec).view(np.uint32))
    back = unravel(tvec)
    for a, b in zip(tree_leaves(back), tree_leaves(tp)):
        assert torch.equal(a, b)


def _inputs(role: str, rng, B=2, S=24):
    if role == "first":
        x = rng.randint(0, 512, (B, S)).astype(np.int32)
        return jnp.asarray(x), torch.from_numpy(x)
    z = rng.randn(B, S, 16).astype(np.float32)
    return jnp.asarray(z, jnp.bfloat16), torch.from_numpy(z).bfloat16()


def _check_grads(tg: dict, jg: dict, jp: dict):
    jleaves = jax.tree_util.tree_leaves_with_path(jg)
    tleaves = list(tree_leaves(tg))
    assert len(jleaves) == len(tleaves)
    for (path, a), b in zip(jleaves, tleaves):
        if np.ndim(a) == 0:
            assert jax.tree_util.keystr(path) == "['alpha_dec']"
            terms = float(np.abs(np.asarray(jp["w_up"])
                                 * np.asarray(jg["w_up"])).sum()
                          / abs(float(jp["alpha_dec"])))
            assert abs(float(b) - float(a)) <= BF16_REL * terms
        else:
            _close_rel(b, a, BF16_REL)
    jflat, _ = ravel_pytree(jg)
    tflat, _ = ravel(tg)
    assert float(cosine_similarity(tflat, torch.from_numpy(
        np.array(jflat)))) >= 0.999


@pytest.mark.parametrize("stage", [0, 1, 2], ids=ROLES)
def test_stage_train_plane_matches_jax(stage):
    jspec, tspec = _specs()
    role = ROLES[stage]
    jp, tp = _params(stage)
    rng = np.random.RandomState(stage)
    jx, tx = _inputs(role, rng)
    _close_rel(sm.stage_forward(tp, tx, tspec, role),
               jsm.stage_forward(jp, jx, jspec, role), BF16_REL)
    if role == "last":
        labels = rng.randint(0, 512, (2, 24)).astype(np.int32)
        jl, jg, jgx = jsm.last_stage_loss_and_grads(
            jp, jx, jnp.asarray(labels), jspec)
        tl, tg, tgx = sm.StageProgram(tspec, stage, device="cpu").\
            loss_and_grads(tp, tx, torch.from_numpy(labels))
        assert abs(float(tl) - float(jl)) <= LOSS_ATOL
    else:
        g = rng.randn(2, 24, 16).astype(np.float32)
        jg, jgx = jsm.stage_backward(jp, jx, jnp.asarray(g, jnp.bfloat16),
                                     jspec, role)
        tg, tgx = sm.StageProgram(tspec, stage, device="cpu").backward(
            tp, tx, torch.from_numpy(g).bfloat16())
    if role == "first":
        assert tgx is None
    else:
        assert tgx.dtype == torch.bfloat16
        _close_rel(tgx, jgx, BF16_REL)
    _check_grads(tg, jg, jp)


def test_adamw_cosine_warmup_ten_steps_match_jax():
    rng = np.random.RandomState(0)
    tree = {"a": rng.randn(3, 5).astype(np.float32),
            "b": {"c": rng.randn(7).astype(np.float32),
                  "d": np.asarray(0.5, np.float32)}}
    jopt = jadamw(jcosine(1e-2, 4, 30), beta1=0.9, beta2=0.95,
                  weight_decay=0.1)
    topt = adamw(cosine_warmup(1e-2, 4, 30), beta1=0.9, beta2=0.95,
                 weight_decay=0.1)
    jp = jax.tree.map(jnp.asarray, tree)
    tp = stage_params_from_numpy(tree, "cpu")
    js, ts = jopt.init(jp), topt.init(tp)
    for step in range(10):
        g = jax.tree.map(
            lambda x: np.asarray(rng.randn(*x.shape), np.float32), tree)
        jp, js = jopt.update(jax.tree.map(jnp.asarray, g), js, jp,
                             jnp.asarray(step, jnp.int32))
        tp, ts = topt.update(stage_params_from_numpy(g, "cpu"), ts, tp, step)
    for a, b in zip(jax.tree_util.tree_leaves(jp), tree_leaves(tp)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), **OPT_TOL)
    for part in ("mu", "nu"):
        for a, b in zip(jax.tree_util.tree_leaves(js[part]),
                        tree_leaves(ts[part])):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), **OPT_TOL)
    for step in (0, 3, 4, 17, 30, 40):
        np.testing.assert_allclose(float(cosine_warmup(1e-2, 4, 30)(step)),
                                   float(jcosine(1e-2, 4, 30)(step)),
                                   rtol=1e-6)


def test_outer_update_matches_jax():
    rng = np.random.RandomState(1)
    anchor = {"w": rng.randn(4, 6).astype(np.float32),
              "s": {"g": rng.randn(3).astype(np.float32)}}
    jstate = jdiloco.outer_init(jax.tree.map(jnp.asarray, anchor))
    tstate = diloco.outer_init(stage_params_from_numpy(anchor, "cpu"))
    for _ in range(3):
        avg = jax.tree.map(lambda x: np.asarray(
            x + 0.1 * rng.randn(*x.shape), np.float32), anchor)
        jstate = jdiloco.outer_update(jstate, jax.tree.map(jnp.asarray, avg),
                                      outer_lr=0.7, outer_momentum=0.9)
        tstate = diloco.outer_update(tstate,
                                     stage_params_from_numpy(avg, "cpu"),
                                     outer_lr=0.7, outer_momentum=0.9)
    assert tstate.outer_step == int(jstate.outer_step) == 3
    for j, t in ((jstate.anchor, tstate.anchor),
                 (jstate.momentum, tstate.momentum)):
        for a, b in zip(jax.tree_util.tree_leaves(j), tree_leaves(t)):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), **OPT_TOL)
    batches = {0: 5, 1: 3, 2: 4, 3: 0}
    assert diloco.effective_batch(batches, 4) == \
        jdiloco.effective_batch(batches, 4)
    for q in (0.25, 0.5, 0.75):
        assert diloco.should_merge(batches, 4, q) == \
            jdiloco.should_merge(batches, 4, q)


@pytest.mark.parametrize("n,length,align", [(2, 1000, 1), (3, 1001, 1),
                                            (5, 4096 + 17, 256),
                                            (4, 3, 1)])
def test_butterfly_plan_identical(n, length, align):
    for seed in (0, 7, 131):
        a = butterfly.make_plan(n, length, seed=seed, align=align)
        b = jbf.make_plan(n, length, seed=seed, align=align)
        assert a.pairs == b.pairs and a.n_shards == b.n_shards
        for s in range(a.n_shards):
            assert a.shard_bounds(s) == b.shard_bounds(s)
        for m in range(n):
            assert a.shards_of(m) == b.shards_of(m)


@pytest.mark.parametrize("n,missing,reducer_ok,tamper", [
    (2, (), None, None),
    (3, (1,), None, None),
    (4, (), (True, False, True, True), {2: 0.5}),
    (5, (0, 3), (False, True, True, False, True), {4: 1e-3}),
])
def test_butterfly_reduce_matches_jax(n, missing, reducer_ok, tamper):
    rng = np.random.RandomState(n)
    L = 997
    uploads = {m: rng.randn(L).astype(np.float32) for m in range(n)
               if m not in missing}
    plan = butterfly.make_plan(n, L, seed=3)
    jplan = jbf.make_plan(n, L, seed=3)
    got = butterfly.reduce_shards(plan, uploads, reducer_ok, tamper,
                                  device="cpu")
    want = jbf.reduce_shards(jplan, uploads, reducer_ok, tamper)
    np.testing.assert_allclose(got[0], want[0], **ULP_TOL)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])
    copies = butterfly.reduce_with_copies(plan, uploads, tamper,
                                          device="cpu")
    jcopies = jbf.reduce_with_copies(jplan, uploads, tamper)
    assert sorted(copies) == sorted(jcopies)
    for key in copies:
        np.testing.assert_allclose(copies[key], jcopies[key], **ULP_TOL)
    np.testing.assert_array_equal(butterfly.agreement_matrix(plan, copies),
                                  jbf.agreement_matrix(jplan, jcopies))


def test_v1_keys_equal_the_reference():
    ks, jks = KeySchema(), JKeySchema()
    keys = [
        (ks.tokens(0, 2), jks.tokens(0, 2)),
        (ks.activation(0, 2, 1, 4), jks.activation(0, 2, 1, 4)),
        (ks.gradient(3, 12, 0, 11), jks.gradient(3, 12, 0, 11)),
        (ks.gradient_for("activations/ep0/t2/s1/m4"),
         jks.gradient_for("activations/ep0/t2/s1/m4")),
        (ks.weight_upload(1, 0, 3), jks.weight_upload(1, 0, 3)),
        (ks.anchor(1, 0), jks.anchor(1, 0)),
        (ks.score(2, 1, 9), jks.score(2, 1, 9)),
        (ks.activations_prefix(5), jks.activations_prefix(5)),
        (ks.weights_prefix(5), jks.weights_prefix(5)),
        (ks.scores_prefix(5), jks.scores_prefix(5)),
    ]
    for got, want in keys:
        assert got == want
    for got, _ in keys[:7]:
        p, jp = ks.parse(got), jks.parse(got)
        assert (p.kind, p.fields) == (jp.kind, jp.fields)
    msgs = [ActivationMsg.tokens(3, 1), ActivationMsg(3, 1, 2, 7),
            GradientMsg(3, 1, 2, 7), WeightUploadMsg(4, 0, 5),
            AnchorMsg(4, 0), ScoreMsg(2, 1, 9)]
    from repro.api import messages as jmsg
    jmsgs = [jmsg.ActivationMsg.tokens(3, 1), jmsg.ActivationMsg(3, 1, 2, 7),
             jmsg.GradientMsg(3, 1, 2, 7), jmsg.WeightUploadMsg(4, 0, 5),
             jmsg.AnchorMsg(4, 0), jmsg.ScoreMsg(2, 1, 9)]
    for m, jm in zip(msgs, jmsgs):
        assert m.key(ks) == jm.key(jks)
    with pytest.raises(ValueError):
        ks.parse("serve/plan")                 # serve keys need v5
