"""The port's layers against ``repro.models.layers``, in f32 on the CPU.

Parameters are drawn by the JAX package and carried over through
``repro_torch.convert``; inputs are numpy arrays from a seed.  Tolerance:
1e-5 (f32; the two packages reduce in another order).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import layers as jl
from repro_torch import configs
from repro_torch.convert import stage_params_from_numpy, tensor_from_numpy
from repro_torch.models import layers as tl

TOL = dict(rtol=1e-5, atol=1e-5)


def _cfgs():
    return (jconfigs.smoke_variant(jconfigs.get("llama3.2-1b")).model,
            configs.smoke_variant(configs.get("llama3.2-1b")).model)


def _params(tree) -> dict:
    return stage_params_from_numpy(jax.tree.map(np.asarray, tree), "cpu")


def _x(*shape, seed=0) -> np.ndarray:
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_config_copies_equal_reference(arch):
    ref, port = jconfigs.get(arch), configs.get(arch)
    assert dataclasses.asdict(ref) == dataclasses.asdict(port)
    assert dataclasses.asdict(jconfigs.smoke_variant(ref)) == \
        dataclasses.asdict(configs.smoke_variant(port))
    assert ref.model.padded_vocab == port.model.padded_vocab


def test_rmsnorm_matches_jax():
    x, g = _x(2, 5, 64), _x(64, seed=1)
    got = tl.rmsnorm(torch.from_numpy(x), torch.from_numpy(g), 1e-5)
    want = jl.rmsnorm(jnp.asarray(x), jnp.asarray(g), 1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_rope_matches_jax():
    pos = np.arange(3, 10, dtype=np.int32)[None].repeat(2, 0)
    cos, sin = tl.rope_angles(torch.from_numpy(pos), 16, 500000.0)
    jcos, jsin = jl.rope_angles(jnp.asarray(pos), 16, 500000.0)
    np.testing.assert_allclose(cos.numpy(), np.asarray(jcos), **TOL)
    np.testing.assert_allclose(sin.numpy(), np.asarray(jsin), **TOL)
    x = _x(2, 7, 4, 16)
    got = tl.apply_rope(torch.from_numpy(x), cos, sin)
    want = jl.apply_rope(jnp.asarray(x), jcos, jsin)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_cached_attention_matches_jax():
    """Prefill into an empty cache, then two single-token steps: outputs
    and cache contents agree, and the port's cache was written in place."""
    jcfg, cfg = _cfgs()
    jp = jl.init_attention(jax.random.key(0), jcfg)
    tp = _params(jp)
    S_max, B = 12, 1
    jcache = jl.KVCache(
        jnp.zeros((B, S_max, jcfg.n_kv_heads, jcfg.head_dim)),
        jnp.zeros((B, S_max, jcfg.n_kv_heads, jcfg.head_dim)),
        jnp.zeros((), jnp.int32))
    shape = (B, S_max, cfg.n_kv_heads, cfg.head_dim)
    tcache = tl.KVCache(torch.zeros(shape), torch.zeros(shape), 0)
    k_buf = tcache.k
    for step, S in enumerate((5, 1, 1)):
        x = _x(B, S, jcfg.d_model, seed=step)
        start = int(tcache.length)
        pos = np.arange(start, start + S, dtype=np.int32)[None]
        want, jcache = jl.attention(jp, jnp.asarray(x), jcfg, None,
                                    jnp.asarray(pos), cache=jcache)
        got, tcache = tl.attention(tp, torch.from_numpy(x), cfg,
                                   torch.from_numpy(pos), cache=tcache)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        np.testing.assert_allclose(tcache.k.numpy(), np.asarray(jcache.k),
                                   **TOL)
        np.testing.assert_allclose(tcache.v.numpy(), np.asarray(jcache.v),
                                   **TOL)
        assert tcache.length == int(jcache.length)
    assert tcache.k is k_buf


def test_uncached_attention_matches_jax():
    jcfg, cfg = _cfgs()
    jp = jl.init_attention(jax.random.key(1), jcfg)
    x = _x(2, 6, jcfg.d_model)
    pos = np.broadcast_to(np.arange(6, dtype=np.int32), (2, 6)).copy()
    want, _ = jl.attention(jp, jnp.asarray(x), jcfg, None, jnp.asarray(pos))
    got, _ = tl.attention(_params(jp), torch.from_numpy(x), cfg,
                          torch.from_numpy(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_mlp_matches_jax():
    jcfg, _ = _cfgs()
    jp = jl.init_mlp(jax.random.key(2), jcfg)
    x = _x(2, 3, jcfg.d_model)
    want = jl.mlp(jp, jnp.asarray(x), None)
    got = tl.mlp(_params(jp), torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_embed_and_logits_match_jax():
    jcfg, cfg = _cfgs()
    jp = jl.init_embeddings(jax.random.key(3), jcfg)
    tp = _params(jp)
    toks = np.random.RandomState(4).randint(0, jcfg.vocab_size, (2, 5))
    toks = toks.astype(np.int32)
    want = jl.embed(jp, jnp.asarray(toks), jcfg, None)
    got = tl.embed(tp, torch.from_numpy(toks), cfg)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))
    x = _x(2, 5, jcfg.d_model)
    want = jl.logits(jp, jnp.asarray(x), jcfg, None)
    got = tl.logits(tp, torch.from_numpy(x), cfg)
    assert got.shape == (2, 5, cfg.padded_vocab)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_bf16_arrays_cross_bit_for_bit():
    a = jnp.asarray(_x(3, 4), jnp.bfloat16)
    t = tensor_from_numpy(np.asarray(a), "cpu")
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                  np.asarray(a).view(np.int16))


def test_port_initializers_and_block_kinds():
    """The port draws its own weights (``torch.Generator``): truncated to
    +-2 standard deviations and scaled as the reference scales them; block
    states start empty; kinds outside the serve slice refuse to run."""
    from repro_torch.common import generator
    from repro_torch.models import blocks as tb

    _, cfg = _cfgs()
    gen = generator("cpu", "test", 0)
    emb = tl.init_embeddings(gen, cfg)
    assert emb["embed"].shape == (cfg.padded_vocab, cfg.d_model)
    assert emb["embed"].abs().max() <= 2.0
    bound = 2.0 / np.sqrt(cfg.padded_vocab)
    assert emb["unembed"].abs().max() <= bound + 1e-6
    assert emb["unembed"].std() > bound / 4
    st = tb.init_block_state(tb.DENSE, cfg, 2, 7, "cpu")
    assert st.k.shape == (2, 7, cfg.n_kv_heads, cfg.head_dim)
    assert st.length == 0 and not st.k.any() and not st.v.any()
    assert tb.period_kinds(cfg) == [tb.DENSE]
    for kind in ("attn_moe", "mamba_dense", "mlstm"):
        with pytest.raises(NotImplementedError, match="slice"):
            tb.init_block(gen, kind, cfg)
