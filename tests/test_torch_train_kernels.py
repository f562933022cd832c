"""The training slice's kernel modules against the JAX package, on the CPU.

  * flash attention without a KV cache (K1's plain version, and its
    gradient) against ``repro.kernels.ref.attention``, ``jax.vjp`` of it,
    and the Pallas ``flash_attention`` run with ``interpret=True``;
  * the masked shard merge (K3's plain version) against ``ref.shard_merge``
    and the Pallas ``shard_merge`` in interpret mode;
  * the int8 sharing codec (through K2a/K2b's plain versions) against
    ``repro.core.compression``, bit for bit.

Tolerances: attention in f32 within 1e-5 (the packages sum in another
order); in bf16 within one bf16 ulp of the f32 result (rtol=2**-7,
atol=1e-6), since both compute in f32 and round once.  Attention gradients
in f32 within 1e-5 (rtol and atol): the same products, summed in another
order.  The shard merge within one f32 ulp (rtol=2**-23): both sum the
miners in index order, but XLA may contract the multiply-add.  Int8 codes,
scales and payload sizes: equal.  On CPU tensors nothing launches a kernel.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import compression as jcomp
from repro.kernels import flash_attention as jfa
from repro.kernels import ref as jref
from repro.kernels import shard_merge as jsm
from repro_torch.core import compression
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops, quant_stream as qs, ref
from repro_torch.kernels import shard_merge as smk

F32_TOL = dict(rtol=1e-5, atol=1e-5)
BF16_TOL = dict(rtol=2.0 ** -7, atol=1e-6)
ULP_TOL = dict(rtol=2.0 ** -23, atol=0.0)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _pair(a: np.ndarray, dtype: str):
    if dtype == "bf16":
        return jnp.asarray(a, jnp.bfloat16), torch.from_numpy(a).to(
            torch.bfloat16)
    return jnp.asarray(a), torch.from_numpy(a)


# ---------------------------------------------------------------------------
# K1: attention without a KV cache
# ---------------------------------------------------------------------------

# (B, Sq, Skv, H, KH, D, causal, q_offset); 100 and 37 are not multiples of
# the card kernel's 64-key tile
FLASH_CASES = [
    (2, 100, 100, 4, 1, 16, True, 0),        # causal, G = 4
    (2, 100, 100, 4, 4, 16, True, 0),        # causal, G = 1
    (1, 37, 100, 4, 1, 32, True, 63),        # a chunk after a prefix
    (2, 100, 100, 4, 1, 16, False, 0),       # bidirectional, G = 4
    (1, 64, 64, 8, 2, 64, False, 0),
    (1, 1, 1, 4, 1, 16, True, 0),
]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("case", FLASH_CASES,
                         ids=lambda c: "x".join(map(str, c)))
def test_flash_attention_matches_jax(case, dtype):
    B, Sq, Skv, H, KH, D, causal, off = case
    rng = np.random.RandomState(Sq * 7 + Skv)
    q = rng.randn(B, Sq, H, D).astype(np.float32)
    k = rng.randn(B, Skv, KH, D).astype(np.float32)
    v = rng.randn(B, Skv, KH, D).astype(np.float32)
    (jq, tq), (jk, tk), (jv, tv) = (_pair(a, dtype) for a in (q, k, v))
    before = fa.LAUNCHES["flash_attention"]
    got = ops.flash_attention(tq, tk, tv, causal=causal, q_offset=off)
    assert fa.LAUNCHES["flash_attention"] == before   # CPU: plain version
    assert got.dtype == tq.dtype and got.shape == tq.shape
    want = jref.attention(jq, jk, jv, causal=causal, q_offset=off)
    pallas = jfa.flash_attention(jq, jk, jv, causal=causal, q_offset=off,
                                 interpret=True)
    tol = F32_TOL if dtype == "f32" else BF16_TOL
    np.testing.assert_allclose(_np(got), _np(want), **tol)
    np.testing.assert_allclose(_np(got), _np(pallas), **tol)


@pytest.mark.parametrize("case", [FLASH_CASES[0], FLASH_CASES[2],
                                  FLASH_CASES[3]],
                         ids=lambda c: "x".join(map(str, c)))
def test_flash_attention_grads_match_jax_vjp(case):
    B, Sq, Skv, H, KH, D, causal, off = case
    rng = np.random.RandomState(5)
    q = rng.randn(B, Sq, H, D).astype(np.float32)
    k = rng.randn(B, Skv, KH, D).astype(np.float32)
    v = rng.randn(B, Skv, KH, D).astype(np.float32)
    g = rng.randn(B, Sq, H, D).astype(np.float32)
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = fa.flash_attention(*leaves, causal=causal, q_offset=off)
    got = torch.autograd.grad(out, leaves, torch.from_numpy(g))
    _, vjp = jax.vjp(lambda a, b, c: jref.attention(
        a, b, c, causal=causal, q_offset=off), jnp.asarray(q),
        jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(g))
    for a, b in zip(got, want):
        np.testing.assert_allclose(_np(a), _np(b), **F32_TOL)


# ---------------------------------------------------------------------------
# K3: masked shard merge
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("M,L,valid", [
    (2, 1000, (1, 1)),
    (3, 20000, (1, 0, 1)),                   # not a multiple of 16384
    (4, 777, (0, 0, 0, 0)),                  # all invalid: zeros
    (9, 4099, (1, 1, 0, 1, 1, 1, 0, 1, 1)),
])
def test_shard_merge_matches_jax(M, L, valid):
    shards = (np.random.RandomState(L).randn(M, L) * 5.0).astype(np.float32)
    mask = np.array(valid, bool)
    before = smk.LAUNCHES["shard_merge"]
    got = ops.shard_merge(torch.from_numpy(shards), torch.from_numpy(mask))
    assert smk.LAUNCHES["shard_merge"] == before
    want = jref.shard_merge(jnp.asarray(shards), jnp.asarray(mask))
    pallas = jsm.shard_merge(jnp.asarray(shards), jnp.asarray(mask),
                             interpret=True)
    np.testing.assert_allclose(_np(got), _np(want), **ULP_TOL)
    np.testing.assert_allclose(_np(got), _np(pallas), **ULP_TOL)
    if not any(valid):
        assert not got.any()


def test_shard_merge_of_a_column_slice():
    """The butterfly merges column slices of one stacked matrix in place;
    a slice gives the same values as a contiguous copy."""
    wide = torch.from_numpy(np.random.RandomState(2).randn(3, 50).astype(
        np.float32))
    mask = torch.tensor([True, True, False])
    assert torch.equal(ref.shard_merge(wide[:, 7:41], mask),
                       ref.shard_merge(wide[:, 7:41].contiguous(), mask))


# ---------------------------------------------------------------------------
# K2a/K2b through the sharing codec
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [256 * 40, 256 * 40 + 77, 5])
def test_int8_sharing_payload_bit_exact(n):
    vec = (np.random.RandomState(n).randn(n) * 0.02).astype(np.float32)
    vec[:256] = 0.0                                # an all-zero block
    before = dict(qs.LAUNCHES)
    got = compression.encode(torch.from_numpy(vec), "int8")
    want = jcomp.encode(jnp.asarray(vec), "int8")
    assert qs.LAUNCHES == before
    assert got["codec"] == want["codec"] and got["n"] == want["n"] == n
    np.testing.assert_array_equal(got["data"].numpy(),
                                  np.asarray(want["data"]))
    np.testing.assert_array_equal(got["scales"].numpy().view(np.uint32),
                                  np.asarray(want["scales"]).view(np.uint32))
    assert compression.payload_bytes(got) == jcomp.payload_bytes(want)
    back = compression.decode(got, n).numpy()
    np.testing.assert_array_equal(
        back.view(np.uint32),
        np.asarray(jcomp.decode(want, n)).view(np.uint32))


@pytest.mark.parametrize("codec", ["none", "bf16"])
def test_plain_sharing_codecs_match_jax(codec):
    vec = np.random.RandomState(1).randn(1000).astype(np.float32)
    got = compression.encode(torch.from_numpy(vec), codec)
    want = jcomp.encode(jnp.asarray(vec), codec)
    assert compression.payload_bytes(got) == jcomp.payload_bytes(want)
    np.testing.assert_array_equal(
        compression.decode(got).numpy(),
        np.asarray(jcomp.decode(want), np.float32))


def test_topk_codec_names_its_slice():
    with pytest.raises(NotImplementedError, match="slice"):
        compression.encode(torch.zeros(8), "topk")


def test_store_put_with_codec_matches_the_reference_store():
    """``StateStore.put(codec=)`` flattens the value and stores the codec's
    payload: equal codes and byte accounting to the reference store's."""
    from repro.runtime.state_store import StateStore as JStore
    from repro_torch.runtime.state_store import StateStore

    vec = (np.random.RandomState(4).randn(3, 300) * 0.1).astype(np.float32)
    got = StateStore().put("weights/ep0/s0/m1", torch.from_numpy(vec),
                           codec="int8")
    want = JStore().put("weights/ep0/s0/m1", jnp.asarray(vec), codec="int8")
    assert got.nbytes == want.nbytes
    assert got.meta == want.meta
    np.testing.assert_array_equal(got.payload["data"].numpy(),
                                  np.asarray(want.payload["data"]))
    np.testing.assert_array_equal(got.payload["scales"].numpy(),
                                  np.asarray(want.payload["scales"]))
