"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Run on a machine with an H100:
    python -m pytest -q -m cuda tests/test_torch_cuda.py
Without a card every test skips (the decision is made in a fixture, never
at import).  This file imports no jax: the card's machine has none.

Tolerances: int8 codes and scales must be equal bit for bit.  Attention
outputs are bf16; kernel and plain version compute in f32 and differ only in
summation order (~1e-6 relative), so after rounding to bf16 they may differ
by one bf16 ulp, at most 2**-7 of the value: rtol=2**-7, atol=1e-6.
"""
import dataclasses

import pytest
import torch

from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import ops, quant_stream as qs, ref

pytestmark = pytest.mark.cuda

ATTN_TOL = dict(rtol=2.0 ** -7, atol=1e-6)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (sm_90)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _gen(seed):
    return torch.Generator(device="cuda").manual_seed(seed)


@pytest.mark.parametrize("n,block", [(16, 16), (48, 16), (1024, 256),
                                     (4096, 1024), (1 << 24, 256)])
def test_quantize_dequantize_bit_exact(dev, n, block):
    x = torch.randn(n, generator=_gen(n), device=dev) * 3.0
    if n // block >= 3:
        x[:block] = 0.0                               # an all-zero block
        # a block with amax 127 has scale exactly 1: x / scale hits .5 ties
        ties = torch.arange(block, device=dev) % 8 - 3.5
        ties[-1] = 127.0
        x[block:2 * block] = ties
    before = dict(qs.LAUNCHES)
    q, s = qs.quantize_int8(x, block=block)
    rq, rs = ref.quantize_int8(x, block=block)
    assert torch.equal(q, rq) and torch.equal(s, rs)
    out = qs.dequantize_int8(q, s, block=block)
    assert torch.equal(out, ref.dequantize_int8(rq, rs, block=block))
    assert qs.LAUNCHES["quantize_int8"] == before["quantize_int8"] + 1
    assert qs.LAUNCHES["dequantize_int8"] == before["dequantize_int8"] + 1


@pytest.mark.parametrize("shape", [(1, 1, 16), (1, 64, 16)])
def test_wire_codec_roundtrip(dev, shape):
    z = torch.randn(shape, generator=_gen(7), device=dev).to(torch.bfloat16)
    q, s = ops.wire_encode(z)
    got = ops.wire_decode(q, s)
    assert torch.equal(got, ref.int8_wire_roundtrip(z.float()))


@pytest.mark.parametrize("Sq,kv_len", [(1, 1), (1, 33), (1, 64), (1, 65),
                                       (1, 80), (64, 64), (7, 71)])
@pytest.mark.parametrize("H,KH,D", [(32, 8, 64), (8, 8, 32), (16, 1, 128)])
def test_decode_attention_matches_plain(dev, Sq, kv_len, H, KH, D):
    B, S_max = 2, 80
    g = _gen(Sq * 1000 + kv_len)
    q = torch.randn(B, Sq, H, D, generator=g, device=dev).to(torch.bfloat16)
    k = torch.randn(B, S_max, KH, D, generator=g, device=dev).to(
        torch.bfloat16)
    v = torch.randn(B, S_max, KH, D, generator=g, device=dev).to(
        torch.bfloat16)
    lens = torch.tensor([kv_len, max(Sq, kv_len - 5)], dtype=torch.int32,
                        device=dev)
    off = lens - Sq
    before = da.LAUNCHES["decode_attention"]
    got = da.decode_attention(q, k, v, q_offset=off, kv_len=lens)
    want = ref.attention(q, k, v, causal=True, q_offset=off, kv_len=lens)
    torch.testing.assert_close(got.float(), want.float(), **ATTN_TOL)
    assert da.LAUNCHES["decode_attention"] == before + 1
    again = da.decode_attention(q, k, v, q_offset=off, kv_len=lens)
    assert torch.equal(got, again)                  # deterministic


def test_wrappers_reject_bad_inputs(dev):
    q = torch.zeros(1, 1, 4, 64, dtype=torch.float32, device=dev)
    with pytest.raises(ValueError):
        da.decode_attention(q, q, q, q_offset=0, kv_len=1)
    with pytest.raises(ValueError):
        qs.quantize_int8(torch.zeros(100, device=dev), block=16)
    with pytest.raises(NotImplementedError, match="K1"):
        ops.flash_attention(q, q, q, causal=True)


def test_serve_parity_on_card(dev):
    """The port's driver and its sequential oracle give identical greedy
    tokens on the card, through the kernels, with the int8 wire."""
    from repro_torch.api.phases import ServeRequest
    from repro_torch.configs import get, smoke_variant
    from repro_torch.launch.serve import serve_swarm, swarm_generate
    from repro_torch.runtime import stage_model as sm

    cfg = dataclasses.replace(smoke_variant(get("llama3.2-1b")).model,
                              d_model=256, n_heads=8, n_kv_heads=2,
                              d_head=64)
    spec = sm.SwarmModelSpec(cfg, 2)
    prompts = torch.randint(3, cfg.vocab_size, (3, 9),
                            generator=torch.Generator().manual_seed(1))
    reqs = [ServeRequest(req=i, prompt=prompts[i].numpy(), max_new=4)
            for i in range(3)]
    before = (da.LAUNCHES["decode_attention"], qs.LAUNCHES["quantize_int8"])
    records = serve_swarm(spec, reqs, n_lanes=2, max_len=13,
                          wire_codec="int8", device="cuda")
    oracle = swarm_generate(spec, 0, reqs, wire_codec="int8", device="cuda")
    for r in reqs:
        assert records[r.req].tokens == oracle[r.req]
    assert da.LAUNCHES["decode_attention"] >= before[0] + 2 * 4 * 3 * 2
    assert qs.LAUNCHES["quantize_int8"] >= before[1] + 4 * 3 * 2
