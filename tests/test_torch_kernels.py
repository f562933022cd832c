"""The port's plain kernel versions against the JAX package, on the CPU.

Each kernel module of the port (decode attention K4, int8 quantize K2a and
dequantize K2b) is held against ``repro.kernels.ref`` and against the
Pallas kernel run with ``interpret=True``, on the same numpy inputs drawn
from a seed.  On CPU tensors the dispatcher takes the plain version and
launches nothing.

Tolerances: attention in f32 within 1e-5 (the two packages sum in another
order); in bf16 within one bf16 ulp of the f32 result (rtol=2**-7, atol=1e-6),
since both compute in f32 and round once.  int8 codes and scales: equal bit
for bit.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import decode_attention as jda
from repro.kernels import ops as jops
from repro.kernels import quant_stream as jqs
from repro.kernels import ref as jref
from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import ops, quant_stream as qs, ref

F32_TOL = dict(rtol=1e-5, atol=1e-5)
BF16_TOL = dict(rtol=2.0 ** -7, atol=1e-6)


def _np(x) -> np.ndarray:
    """A JAX or torch array as f32 numpy."""
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _pair(a: np.ndarray, dtype: str):
    """The same values as a JAX array and a torch CPU tensor."""
    if dtype == "bf16":
        return jnp.asarray(a, jnp.bfloat16), torch.from_numpy(a).to(
            torch.bfloat16)
    return jnp.asarray(a), torch.from_numpy(a)


# ---------------------------------------------------------------------------
# K4: cached-decode attention
# ---------------------------------------------------------------------------

# (B, Sq, S_max, kv_len, H, KH, D): q rows sit at [kv_len - Sq, kv_len)
DA_CASES = [
    (1, 1, 24, 1, 4, 1, 16),       # first decoded token, G = 4
    (2, 1, 40, 23, 4, 4, 16),      # decode, G = 1, two lanes
    (1, 7, 40, 7, 4, 1, 32),       # prefill into an empty cache
    (1, 7, 40, 30, 8, 2, 16),      # chunk appended to a filled cache
    (1, 32, 40, 32, 4, 1, 16),     # whole-cache prefill
    (1, 32, 64, 40, 4, 4, 64),     # prefill past the first 32 rows
]


@pytest.mark.parametrize("case", DA_CASES, ids=lambda c: "x".join(map(str, c)))
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_decode_attention_matches_jax(case, dtype):
    B, Sq, S_max, L, H, KH, D = case
    rng = np.random.RandomState(sum(case))
    qn = rng.randn(B, Sq, H, D).astype(np.float32)
    kn = rng.randn(B, S_max, KH, D).astype(np.float32)
    vn = rng.randn(B, S_max, KH, D).astype(np.float32)
    (jq, tq), (jk, tk), (jv, tv) = (_pair(a, dtype) for a in (qn, kn, vn))
    off = L - Sq
    jlens = jnp.full((B,), L, jnp.int32)

    got = da.decode_attention(tq, tk, tv, q_offset=off, kv_len=L)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    want = jref.attention(jq, jk, jv, causal=True, q_offset=off,
                          kv_len=jlens)
    pallas = jda.decode_attention(jq, jk, jv, q_offset=off, kv_len=jlens,
                                  interpret=True, bkv=16)
    tol = F32_TOL if dtype == "f32" else BF16_TOL
    np.testing.assert_allclose(_np(got), _np(want), **tol)
    np.testing.assert_allclose(_np(got), _np(pallas), **tol)


def test_attention_per_batch_offsets_match_scalar_calls():
    """The port takes a (B,) ``q_offset``; each row equals the reference's
    scalar-offset call for that batch element."""
    rng = np.random.RandomState(3)
    q = rng.randn(2, 3, 4, 16).astype(np.float32)
    k = rng.randn(2, 20, 2, 16).astype(np.float32)
    lens = np.array([9, 14], np.int32)
    got = ref.attention(torch.from_numpy(q), torch.from_numpy(k),
                        torch.from_numpy(k), causal=True,
                        q_offset=torch.from_numpy(lens - 3),
                        kv_len=torch.from_numpy(lens))
    for b in range(2):
        want = jref.attention(jnp.asarray(q[b:b + 1]), jnp.asarray(k[b:b + 1]),
                              jnp.asarray(k[b:b + 1]), causal=True,
                              q_offset=int(lens[b]) - 3,
                              kv_len=jnp.asarray(lens[b:b + 1]))
        np.testing.assert_allclose(_np(got[b:b + 1]), _np(want), **F32_TOL)


# ---------------------------------------------------------------------------
# K2a / K2b: int8 blockwise codec
# ---------------------------------------------------------------------------


def _codec_input(n: int, block: int, seed: int) -> np.ndarray:
    x = (np.random.RandomState(seed).randn(n) * 3.0).astype(np.float32)
    x[:block] = 0.0                          # an all-zero block: scale 1
    # amax 127 makes the scale exactly 1, so x / scale lands on .5 ties
    ties = (np.arange(block) % 8 - 3.5).astype(np.float32)
    ties[-1] = 127.0
    x[block:2 * block] = ties
    x[2 * block:3 * block] *= 1e-30          # tiny values
    return x


@pytest.mark.parametrize("n,block", [(64, 16), (16 * 40, 16), (1024, 256),
                                     (256 * 9, 256)])
def test_quantize_bit_exact_vs_jax(n, block):
    """Codes and scales equal ``repro.kernels.ref.quantize_int8`` bit for
    bit, and the codes equal the Pallas kernel's.  The Pallas kernel, traced
    under jit, gets ``amax / 127.0`` rewritten by XLA into
    ``amax * f32(1 / 127)``, one ulp off the division on some blocks: its
    scales are checked against that product, exactly."""
    x = _codec_input(n, block, n + block)
    q, s = qs.quantize_int8(torch.from_numpy(x), block=block)
    rq, rs = jref.quantize_int8(jnp.asarray(x), block=block)
    pq, ps = jqs.quantize_int8(jnp.asarray(x), block=block, interpret=True)
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    np.testing.assert_array_equal(s.numpy().view(np.uint32),
                                  np.asarray(rs).view(np.uint32))
    np.testing.assert_array_equal(q.numpy(), np.asarray(pq))
    amax = np.abs(x.reshape(-1, block)).max(axis=1)
    recip = np.where(amax > 0, amax * np.float32(1.0 / 127.0),
                     np.float32(1.0)).astype(np.float32)
    np.testing.assert_array_equal(np.asarray(ps).view(np.uint32),
                                  recip.view(np.uint32))
    assert q.numpy()[block:2 * block].tolist()[:8] == \
        [-4, -2, -2, 0, 0, 2, 2, 4]          # half to even


@pytest.mark.parametrize("n,block", [(64, 16), (1024, 256)])
def test_dequantize_bit_exact_vs_jax(n, block):
    x = _codec_input(n, block, 5)
    rq, rs = jref.quantize_int8(jnp.asarray(x), block=block)
    tq = torch.from_numpy(np.array(rq))
    ts = torch.from_numpy(np.array(rs))
    got = qs.dequantize_int8(tq, ts, block=block).numpy()
    want = np.asarray(jref.dequantize_int8(rq, rs, block=block))
    pallas = np.asarray(jqs.dequantize_int8(rq, rs, block=block,
                                            interpret=True))
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    np.testing.assert_array_equal(got.view(np.uint32),
                                  pallas.view(np.uint32))


@pytest.mark.parametrize("shape", [(1, 1, 16), (1, 64, 16), (2, 3, 16)])
def test_wire_codec_matches_jax(shape):
    """``wire_encode``/``wire_decode`` pick the reference's block (256 when
    it divides, else one scale per code row) and its exact codes."""
    z = np.random.RandomState(11).randn(*shape).astype(np.float32)
    jz, tz = _pair(z, "bf16")
    q, s = ops.wire_encode(tz)
    jq, js = jops.wire_encode(jz)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    np.testing.assert_array_equal(ops.wire_decode(q, s).numpy(),
                                  np.asarray(jops.wire_decode(jq, js)))
    assert qs.wire_block(z.size, shape[-1]) == \
        jqs.wire_block(z.size, shape[-1])
    assert qs.wire_nbytes(shape) == jqs.wire_nbytes(shape)


def test_cpu_tensors_launch_no_kernel():
    before = dict(da.LAUNCHES, **qs.LAUNCHES)
    x = torch.randn(1, 4, 4, 16)
    da.decode_attention(x, x, x, q_offset=0, kv_len=4)
    ops.flash_attention(x, x, x, causal=True, kv_len=torch.tensor([4]))
    ops.wire_decode(*ops.wire_encode(torch.randn(1, 4, 16)))
    assert dict(da.LAUNCHES, **qs.LAUNCHES) == before
    assert all(v == 0 for v in before.values())
