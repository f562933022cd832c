"""The port's serve plane against the JAX package, and against itself.

  * timetables and store keys equal the reference's exactly;
  * each stage role's ``decode_step`` on imported parameters matches the
    JAX stage program at prefill and three teacher-forced decode steps;
  * the port's pipelined ``ServeDriver`` emits the tokens of its own
    sequential ``swarm_generate``, bit for bit, for P in {1, 2, 4}, the
    int8 wire and a mid-flight admission;
  * its greedy tokens equal JAX ``swarm_generate``'s wherever the JAX
    top-1/top-2 logit margin is wider than the logit tolerance;
  * the in-process store accounts the reference's bytes exactly.

Tolerance (bf16): activations run in bf16, and XLA and PyTorch round bf16
intermediates at different places (XLA fuses elementwise chains in f32),
so outputs differ by a few bf16 ulps per layer.  Boundary codes must agree
within 2**-5 of their largest magnitude, logits within 2**-5 absolute
(logits here are O(1)); ``MARGIN`` is twice that.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.api.keys import KeySchema as JKeySchema
from repro.api.phases import ServeRequest as JServeRequest
from repro.core import pipeline as jpipe
from repro.launch import serve as jserve
from repro.runtime import stage_model as jsm
from repro_torch import configs
from repro_torch.api.keys import KeySchema
from repro_torch.api.phases import ServeDriver, ServeRequest
from repro_torch.api.transport import InProcessTransport
from repro_torch.convert import stage_params_from_numpy, tensor_from_numpy
from repro_torch.core import pipeline as tpipe
from repro_torch.launch import serve as tserve
from repro_torch.runtime import stage_model as sm

CODE_RTOL = 2.0 ** -5
LOGIT_ATOL = 2.0 ** -5
MARGIN = 2 * LOGIT_ATOL


def _cfgs(n_layers):
    j = dataclasses.replace(
        jconfigs.smoke_variant(jconfigs.get("llama3.2-1b")).model,
        n_layers=n_layers)
    t = dataclasses.replace(
        configs.smoke_variant(configs.get("llama3.2-1b")).model,
        n_layers=n_layers)
    return j, t


def _specs(n_stages, n_layers=None):
    jc, tc = _cfgs(n_layers or n_stages)
    return jsm.SwarmModelSpec(jc, n_stages), sm.SwarmModelSpec(tc, n_stages)


def _prompts(n, length, seed=1):
    return np.random.RandomState(seed).randint(3, 512, (n, length)).astype(
        np.int32)


def _requests(n, length, max_new, **kw):
    return [ServeRequest(req=i, prompt=p, max_new=max_new, **kw)
            for i, p in enumerate(_prompts(n, length))]


def _jrequests(reqs):
    return [JServeRequest(req=r.req, prompt=r.prompt, max_new=r.max_new,
                          temperature=r.temperature,
                          arrival_round=r.arrival_round) for r in reqs]


def _imported(jspec, seed, stage):
    return stage_params_from_numpy(
        jax.tree.map(np.asarray, jsm.serve_stage_params(jspec, seed, stage)),
        "cpu")


# ---------------------------------------------------------------------------
# pure-Python artifacts: timetables and keys
# ---------------------------------------------------------------------------

TIMETABLE_FIELDS = ("n_slots", "z_ring", "g_ring", "role", "micro", "vstage",
                    "z_arrive", "z_src", "g_arrive", "g_src", "f_slot",
                    "b_slot", "w_slot")


@pytest.mark.parametrize("schedule,P,M,V", [
    ("decode", 1, 1, 1), ("decode", 2, 3, 1), ("decode", 4, 8, 1),
    ("gpipe", 4, 8, 1), ("1f1b", 3, 5, 1), ("zerobubble", 4, 8, 1),
    ("interleaved", 2, 4, 2)])
def test_timetables_equal_reference(schedule, P, M, V):
    got = tpipe.compile_timetable(schedule, P, M, V)
    want = jpipe.compile_timetable(schedule, P, M, V)
    for field in TIMETABLE_FIELDS:
        np.testing.assert_array_equal(getattr(got, field),
                                      getattr(want, field), err_msg=field)
    assert got.bubble_fraction() == want.bubble_fraction()


def test_serve_keys_equal_reference():
    ks, jks = KeySchema(version=5), JKeySchema(version=5)
    calls = [("serve_plan", ()), ("serve_round_plan", (7,)),
             ("serve_code", (3, 1, 2)), ("serve_request", (9,)),
             ("serve_token", (9, 4)), ("serve_done", (9,)),
             ("serve_round_prefix", (3,)), ("serve_request_prefix", (9,))]
    for name, args in calls:
        key = getattr(ks, name)(*args)
        assert key == getattr(jks, name)(*args), name
        if not name.endswith("prefix"):
            got, want = ks.parse(key), jks.parse(key)
            assert (got.kind, got.fields) == (want.kind, want.fields)
    with pytest.raises(ValueError):
        KeySchema(version=4).serve_plan()


# ---------------------------------------------------------------------------
# stage programs on imported parameters
# ---------------------------------------------------------------------------


def _stage_input(role, S, rng, db):
    if role in ("first", "solo"):
        return rng.randint(3, 512, (1, S)).astype(np.int32)
    z = rng.randn(1, S, db).astype(np.float32)
    return np.asarray(jnp.asarray(z, jnp.bfloat16))


@pytest.mark.parametrize("n_stages,stage,role", [
    (1, 0, "solo"), (4, 0, "first"), (4, 1, "mid"), (4, 3, "last")])
def test_stage_decode_step_matches_jax(n_stages, stage, role):
    jspec, tspec = _specs(n_stages, n_layers=4)
    jprog = jsm.StageProgram(jspec, stage)
    tprog = sm.StageProgram(tspec, stage, device="cpu")
    assert jprog.role == tprog.role == role
    jparams = jsm.serve_stage_params(jspec, 0, stage)
    tparams = _imported(jspec, 0, stage)
    S, steps = 6, 3
    jcache = jprog.init_cache(1, S + steps)
    tcache = tprog.init_cache(1, S + steps)
    rng = np.random.RandomState(stage)
    for i, rows in enumerate([S] + [1] * steps):
        x = _stage_input(role, rows, rng, jspec.bottleneck_dim)
        jout, jcache = jprog.decode_step(jparams, jnp.asarray(x), jcache)
        tout, tcache = tprog.decode_step(tparams,
                                         tensor_from_numpy(x, "cpu"), tcache)
        want = np.asarray(jout, np.float32)
        got = tout.float().numpy()
        assert got.shape == want.shape, i
        if role in ("last", "solo"):
            np.testing.assert_allclose(got, want, rtol=0, atol=LOGIT_ATOL,
                                       err_msg=f"step {i}")
        else:
            assert tout.dtype == torch.bfloat16
            np.testing.assert_allclose(
                got, want, rtol=0, atol=CODE_RTOL * np.abs(want).max(),
                err_msg=f"step {i}")
    assert tcache.length == S + steps


def _jax_teacher_forced(jspec, seed, prompt, toks, wire):
    """JAX last-position logits at each step of a request whose stream is
    ``toks`` (the prompt at step 0, then token i - 1 at step i)."""
    P = jspec.n_stages
    progs = [jsm.StageProgram(jspec, s, wire) for s in range(P)]
    params = [jsm.serve_stage_params(jspec, seed, s) for s in range(P)]
    caches = [p.init_cache(1, prompt.size + len(toks)) for p in progs]
    out = []
    for i in range(len(toks)):
        h = jnp.asarray(prompt[None]) if i == 0 \
            else jnp.asarray([[toks[i - 1]]], jnp.int32)
        for s in range(P):
            h, caches[s] = progs[s].decode_step(params[s], h, caches[s])
            if s < P - 1:
                h = progs[s].decode_wire(progs[s].encode_wire(h))
        out.append(np.asarray(h[0, -1], np.float32))
    return out


def _port_teacher_forced(jspec, tspec, seed, prompt, toks, wire):
    P = tspec.n_stages
    progs = [sm.StageProgram(tspec, s, wire, "cpu") for s in range(P)]
    params = [_imported(jspec, seed, s) for s in range(P)]
    caches = [p.init_cache(1, prompt.size + len(toks)) for p in progs]
    out = []
    for i in range(len(toks)):
        h = torch.from_numpy(prompt[None]) if i == 0 \
            else torch.tensor([[toks[i - 1]]], dtype=torch.int32)
        for s in range(P):
            h, caches[s] = progs[s].decode_step(params[s], h, caches[s])
            if s < P - 1:
                h = progs[s + 1].decode_wire(progs[s].encode_wire(h))
        out.append(h[0, -1].float().numpy())
    return out


@pytest.mark.parametrize("P,wire", [(2, "none"), (2, "int8")])
def test_greedy_tokens_match_jax_where_decided(P, wire):
    """Teacher-forced on the JAX token stream, so one near-tie cannot fork
    the rest: at every step whose JAX top-1/top-2 margin exceeds MARGIN,
    the port's argmax is the JAX token."""
    jspec, tspec = _specs(P, n_layers=4)
    reqs = _requests(3, 6, max_new=8)
    jtoks = jserve.swarm_generate(jspec, 0, _jrequests(reqs),
                                  wire_codec=wire)
    decided = total = 0
    for r in reqs:
        toks = jtoks[r.req]
        jlog = _jax_teacher_forced(jspec, 0, r.prompt, toks, wire)
        tlog = _port_teacher_forced(jspec, tspec, 0, r.prompt, toks, wire)
        for i, (jl, tl) in enumerate(zip(jlog, tlog)):
            assert int(np.argmax(jl)) == toks[i]
            np.testing.assert_allclose(tl, jl, rtol=0, atol=LOGIT_ATOL)
            top2 = np.sort(jl)[-2:]
            total += 1
            if top2[1] - top2[0] > MARGIN:
                decided += 1
                assert int(np.argmax(tl)) == toks[i], (r.req, i)
    assert decided >= total // 3, (decided, total)     # not vacuous


# ---------------------------------------------------------------------------
# the port's driver against its own oracle
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("P", [1, 2, 4])
@pytest.mark.parametrize("wire", ["none", "int8"])
def test_driver_matches_port_oracle(P, wire):
    _, spec = _specs(P, n_layers=4)
    reqs = _requests(3, 5, max_new=4)
    records = tserve.serve_swarm(spec, reqs, n_lanes=2, max_len=9,
                                 wire_codec=wire, device="cpu")
    oracle = tserve.swarm_generate(spec, 0, reqs, wire_codec=wire,
                                   device="cpu")
    for r in reqs:
        assert records[r.req].tokens == oracle[r.req]
        assert len(oracle[r.req]) == 4


def test_mid_flight_admission_does_not_perturb_running_lanes():
    _, spec = _specs(2)
    base = _requests(3, 5, max_new=5)
    staggered = [dataclasses.replace(base[0]),
                 dataclasses.replace(base[1], max_new=2),
                 dataclasses.replace(base[2], arrival_round=1)]
    with_late = tserve.serve_swarm(spec, staggered, n_lanes=2, max_len=10,
                                   wire_codec="int8", device="cpu")
    without = tserve.serve_swarm(spec, staggered[:2], n_lanes=2, max_len=10,
                                 wire_codec="int8", device="cpu")
    for r in staggered[:2]:
        assert with_late[r.req].tokens == without[r.req].tokens
    oracle = tserve.swarm_generate(spec, 0, staggered, wire_codec="int8",
                                   device="cpu")
    for r in staggered:
        assert with_late[r.req].tokens == oracle[r.req]


def test_temperature_sampling_reproduces_oracle():
    _, spec = _specs(2)
    reqs = _requests(2, 5, max_new=4, temperature=0.8)
    records = tserve.serve_swarm(spec, reqs, n_lanes=2, max_len=9,
                                 device="cpu")
    oracle = tserve.swarm_generate(spec, 0, reqs, device="cpu")
    for r in reqs:
        assert records[r.req].tokens == oracle[r.req]


@pytest.mark.parametrize("P,wire", [(2, "int8"), (2, "none"), (1, "none")])
def test_traffic_report_equals_reference(P, wire):
    """Same requests (with a late arrival), same store keys, same payload
    shapes: the per-namespace and per-actor byte counts are equal."""
    jspec, tspec = _specs(P)
    reqs = _requests(3, 5, max_new=3)
    reqs[2] = dataclasses.replace(reqs[2], arrival_round=4)
    tp = InProcessTransport(schema=KeySchema(version=5))
    ServeDriver(tspec, tp, n_lanes=2, max_len=8, wire_codec=wire,
                servers=tserve.build_servers(tspec, 0, n_lanes=2, max_len=8,
                                             wire_codec=wire,
                                             device="cpu")).run(reqs)
    from repro.api.phases import ServeDriver as JServeDriver
    from repro.api.transport import InProcessTransport as JTransport
    jtp = JTransport(schema=JKeySchema(version=5))
    JServeDriver(jspec, jtp, n_lanes=2, max_len=8, wire_codec=wire,
                 servers=jserve.build_servers(jspec, 0, n_lanes=2, max_len=8,
                                              wire_codec=wire)
                 ).run(_jrequests(reqs))
    assert tp.traffic_report() == jtp.traffic_report()
    assert tp.keys() == jtp.keys()


def test_driver_records_latency_and_gcs_rounds():
    _, spec = _specs(1)
    reqs = _requests(2, 4, max_new=3)
    tp = InProcessTransport(schema=KeySchema(version=5))
    driver = ServeDriver(spec, tp, n_lanes=2, max_len=7,
                         servers=tserve.build_servers(spec, 0, n_lanes=2,
                                                      max_len=7,
                                                      device="cpu"))
    records = driver.run(reqs)
    assert driver.rounds_run == 3
    for rec in records.values():
        assert len(rec.tokens) == 3
        assert 0 <= rec.ttft <= rec.total
    assert not tp.keys(tp.schema.serve_round_prefix(0))
    assert tp.exists(tp.schema.serve_done(0))


def test_entry_points_refuse_to_run_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    _, spec = _specs(1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tserve.serve_swarm(spec, _requests(1, 4, max_new=1), n_lanes=1,
                           max_len=5)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tserve.swarm_generate(spec, 0, _requests(1, 4, max_new=1))
    with pytest.raises(NotImplementedError, match="multi-process"):
        tserve.serve_swarm(spec, [], n_lanes=1, max_len=5,
                           transport="socket", device="cpu")
