"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Run on a machine with an H100:
    python -m pytest -q -m cuda tests/test_torch_cuda.py
Without a card every test skips (the decision is made in a fixture, never
at import).  This file imports no jax: the card's machine has none.

Tolerances: int8 codes and scales, and the shard merge, must be equal bit
for bit.  Attention outputs are bf16; kernel and plain version compute in
f32 and differ only in summation order (~1e-6 relative), so after rounding
to bf16 they may differ by one bf16 ulp, at most 2**-7 of the value:
rtol=2**-7, atol=1e-6.  The flash kernel's autograd Function differentiates
the plain version on the same inputs, so its gradients equal the plain
version's bit for bit.  A small swarm trained on the card holds its integer
census (pathways, batches, merges, verdicts) equal to the same swarm on the
CPU, and its per-epoch mean loss within ``CARD_LOSS_ATOL`` (bf16 products
on cuBLAS and on the CPU round differently; the losses are ~6.2).
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops, quant_stream as qs, ref
from repro_torch.kernels import shard_merge as smk

pytestmark = pytest.mark.cuda

ATTN_TOL = dict(rtol=2.0 ** -7, atol=1e-6)
CARD_LOSS_ATOL = 2e-2


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
    with pytest.raises(ValueError):            # K1 takes bf16 only
        ops.flash_attention(q, q, q, causal=True)
    with pytest.raises(ValueError):            # head dim 16 is not built
        fa.flash_attention(*(torch.zeros(1, 4, 2, 16, dtype=torch.bfloat16,
                                         device=dev),) * 3)


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


# ---------------------------------------------------------------------------
# K1 (flash attention) and K3 (shard merge): the training slice's kernels
# ---------------------------------------------------------------------------

# (B, Sq, Skv, H, KH, D, causal, q_offset)
FLASH_CASES = [
    (4, 512, 512, 32, 8, 64, True, 0),       # the training run's shape
    (1, 2048, 2048, 32, 8, 64, True, 0),
    (2, 1, 1, 32, 8, 64, True, 0),
    (2, 100, 100, 32, 8, 64, True, 0),
    (2, 100, 300, 8, 8, 32, True, 200),      # a chunk after a prefix
    (2, 37, 300, 16, 1, 128, True, 263),
    (2, 100, 100, 32, 8, 64, False, 0),      # bidirectional
    (1, 65, 130, 16, 4, 128, False, 0),
]


def _qkv(B, Sq, Skv, H, KH, D, seed):
    g = _gen(seed)
    q = torch.randn(B, Sq, H, D, generator=g, device="cuda")
    k = torch.randn(B, Skv, KH, D, generator=g, device="cuda")
    v = torch.randn(B, Skv, KH, D, generator=g, device="cuda")
    return q.bfloat16(), k.bfloat16(), v.bfloat16()


@pytest.mark.parametrize("case", FLASH_CASES,
                         ids=lambda c: "x".join(map(str, c)))
def test_flash_attention_matches_plain(dev, case):
    B, Sq, Skv, H, KH, D, causal, off = case
    q, k, v = _qkv(B, Sq, Skv, H, KH, D, Sq + Skv)
    before = fa.LAUNCHES["flash_attention"]
    got = ops.flash_attention(q, k, v, causal=causal, q_offset=off)
    want = ref.attention(q, k, v, causal=causal, q_offset=off)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), **ATTN_TOL)
    assert fa.LAUNCHES["flash_attention"] == before + 1
    assert torch.equal(got, ops.flash_attention(q, k, v, causal=causal,
                                                q_offset=off))


@pytest.mark.parametrize("case", [FLASH_CASES[0], FLASH_CASES[4],
                                  FLASH_CASES[6]],
                         ids=lambda c: "x".join(map(str, c)))
def test_flash_attention_grads_match_plain(dev, case):
    B, Sq, Skv, H, KH, D, causal, off = case
    q, k, v = _qkv(B, Sq, Skv, H, KH, D, 3)
    g = torch.randn(B, Sq, H, D, generator=_gen(4), device="cuda").bfloat16()
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = fa.flash_attention(*leaves, causal=causal, q_offset=off)
    got = torch.autograd.grad(out, leaves, g)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(
        ref.attention(*leaves, causal=causal, q_offset=off), leaves, g)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("M,L,valid", [
    (2, 1 << 20, (1, 1)), (2, 1001, (1, 1)), (3, 16391, (1, 0, 1)),
    (3, 1000, (0, 0, 0)), (5, 4099, (0, 1, 1, 0, 1))])
def test_shard_merge_bit_exact(dev, M, L, valid):
    shards = torch.randn(M, L, generator=_gen(L), device="cuda") * 5.0
    mask = torch.tensor(valid, dtype=torch.bool, device="cuda")
    before = smk.LAUNCHES["shard_merge"]
    got = ops.shard_merge(shards, mask)
    assert torch.equal(got, ref.shard_merge(shards, mask))
    assert smk.LAUNCHES["shard_merge"] == before + 1
    # a column slice of a wider matrix, read in place (odd offset: the
    # kernel's single-float path)
    wide = torch.randn(M, L + 7, generator=_gen(1), device="cuda")
    part = wide[:, 3:3 + L]
    assert torch.equal(ops.shard_merge(part, mask),
                       ref.shard_merge(part, mask))


def test_small_swarm_on_card_matches_cpu(dev):
    """A 2-stage x 2-miner swarm of a small llama-family model (head_dim
    64, which K1 is built for) trains two epochs on the card through K1,
    K2a/K2b and K3, with the census of the same swarm on the CPU."""
    from repro_torch.api.config import SwarmConfig
    from repro_torch.api.swarm import Swarm
    from repro_torch.common import tree_map
    from repro_torch.configs import get, smoke_variant
    from repro_torch.convert import load_swarm_state

    cfg = dataclasses.replace(smoke_variant(get("llama3.2-1b")).model,
                              d_model=256, n_heads=8, n_kv_heads=2,
                              d_head=64, n_layers=4)
    sc = SwarmConfig(n_stages=2, miners_per_stage=2, inner_steps=12,
                     seq_len=64, seed=0)
    cpu = Swarm.create(cfg, sc, device="cpu")
    card = Swarm.create(cfg, sc, device="cuda")
    load_swarm_state(card, [tree_map(lambda t: t.numpy(), a)
                            for a in cpu.anchors])
    before = (fa.LAUNCHES["flash_attention"], smk.LAUNCHES["shard_merge"],
              qs.LAUNCHES["quantize_int8"])
    want, got = cpu.run(2), card.run(2)
    torch.cuda.synchronize()
    for w, g in zip(want, got):
        assert g.batches == w.batches and g.b_eff == w.b_eff
        assert g.merged_stages == w.merged_stages
        assert [(r.miner_uid, r.checked, r.passed) for r in g.validation] \
            == [(r.miner_uid, r.checked, r.passed) for r in w.validation]
        assert abs(g.mean_loss - w.mean_loss) <= CARD_LOSS_ATOL
        assert np.isfinite(g.mean_loss)
    assert sum(s.merged_stages for s in got) >= 1
    assert fa.LAUNCHES["flash_attention"] > before[0]
    assert smk.LAUNCHES["shard_merge"] > before[1]
    assert qs.LAUNCHES["quantize_int8"] > before[2]
