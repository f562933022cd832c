"""Chip smoke run of the PyTorch/CUDA port (``src/repro_torch``).

Run from the repository root on a machine with one H100:

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. device: the card's name, capability, and name/power limit from
     nvidia-smi; exits non-zero without a CUDA device or off sm_90.
  2. build: every kernel source of the serve and training paths, one nvcc
     each, all at once.
  3. kernels: each kernel's wrapper against its plain PyTorch version at the
     paths' shapes (int8 codes and the shard merge bit for bit; attention
     within one bf16 ulp: rtol 2**-7, atol 1e-6; the flash kernel's autograd
     gradients equal to the plain version's), with CUDA-event and profiler
     device times of the kernel, the plain version and, for attention, one
     library call (SDPA) as yardstick; each with its bound (bytes over
     3.35 TB/s against operations over the type's peak).
  4. reference: a small model served on the card through the kernels
     agrees with the same model on the CPU (plain versions, themselves held
     to the JAX package by the CPU tests): logits within 2**-5, greedy
     tokens equal wherever the CPU's top-2 margin exceeds 2 * 2**-5.
  5. serve: llama3.2-1b at full width (16 layers, d_model 2048, 32 heads,
     8 KV heads, padded vocab 128512), random weights from a seed, 2 stages,
     int8 wire, 2 lanes, 4 greedy requests of 64 prompt tokens and 16 new
     ones, through ``serve_swarm``; the launch counters are zeroed just
     before and read just after, and every kernel must have run.  The
     sequential ``swarm_generate`` must give the same tokens, and one
     full-width prefill must give finite logits of the expected shape.
  6. profile: the same serve workload again under torch.profiler, for the
     device's busy time, idle share and the kernels that take it.
  7. train reference: a small 2-stage x 2-miner swarm (head_dim 64) trained
     two epochs on the card has the census (batches, merges, verdicts) of
     the same swarm on the CPU, and per-epoch mean losses within 2e-2.
  8. train: llama3.2-1b at full width, random weights from seed 0, through
     ``Swarm.create(..., device="cuda").run(2)`` with SwarmConfig(n_stages=2,
     miners_per_stage=2, inner_steps=16, b_min=4, batch_size=4,
     seq_len=512, share_codec="int8", sync_mode="dense", seed=0); the
     launch counters are zeroed just before and read just after, and K1,
     K3, K2a and K2b must have run.  Every mean loss finite, a merge in some
     epoch, every honest miner's work validated.  Prints per-epoch loss,
     b_eff and merges, seconds per phase, ticks/s, launches, peak device
     memory and the host's max RSS.
  9. train profile: one more training tick, and one more sharing + sync of
     stage 0 on the trained miners, under torch.profiler: device busy
     against wall and the top device operations.
Then one JSON line of kernels, the nvidia-smi line, and the result line.
"""
from __future__ import annotations

import dataclasses
import json
import os
import resource
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory
BF16_FLOP_PER_S = 989e12           # dense bf16 tensor-core peak
F32_FLOP_PER_S = 67e12             # f32 outside the tensor cores
ATTN_TOL = dict(rtol=2.0 ** -7, atol=1e-6)
LOGIT_ATOL = 2.0 ** -5
TRAIN_LOSS_ATOL = 2e-2


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 \
        else f"nvidia-smi failed: {out.stderr.strip()}"


def cuda_ms(fn, iters: int = 100, warmup: int = 10) -> float:
    """Mean milliseconds per call over ``iters`` back-to-back calls, timed
    with CUDA events after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_events(fn) -> list:
    """Per-name CUDA activity (kernels, copies) of one call of ``fn``, from
    torch.profiler; empty if the profiler sees no device activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total]


def device_ms(fn, match, iters: int = 50):
    """Device time per call of the kernels whose name ``match`` accepts,
    from the profiler, or None where it saw none (the host-side wrapper's
    time is what ``cuda_ms`` adds on top)."""
    def calls():
        for _ in range(iters):
            fn()                  # no result kept: some are GBs each
    evs = device_events(calls)
    total_us = sum(e.self_device_time_total for e in evs if match(e.key))
    return total_us / iters / 1e3 if total_us else None


def bound_ms(nbytes: float, ops: float, peak: float) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / peak
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------


def check_decode_attention(da, ref) -> dict:
    """K4 at the serve path's shapes: one decode step (Sq = 1) and the
    prefill of a 64-token prompt (Sq = 64), over a cache of 80, H = 32,
    KH = 8, D = 64."""
    B, S_max, H, KH, D = 1, 80, 32, 8, 64
    gen = torch.Generator(device="cuda").manual_seed(4)
    k = torch.randn(B, S_max, KH, D, generator=gen, device="cuda").to(
        torch.bfloat16)
    v = torch.randn(B, S_max, KH, D, generator=gen, device="cuda").to(
        torch.bfloat16)
    shapes, max_err = [], 0.0
    for Sq, kv_len in [(1, 1), (1, 65), (1, 80), (64, 64)]:
        q = torch.randn(B, Sq, H, D, generator=gen, device="cuda").to(
            torch.bfloat16)
        lens = torch.full((B,), kv_len, dtype=torch.int32, device="cuda")
        off = lens - Sq
        got = da.decode_attention(q, k, v, q_offset=off, kv_len=lens)
        want = ref.attention(q, k, v, causal=True, q_offset=off, kv_len=lens)
        torch.cuda.synchronize()
        torch.testing.assert_close(got.float(), want.float(), **ATTN_TOL)
        max_err = max(max_err, (got.float() - want.float()).abs().max().item())
        # yardstick: one SDPA call on the same tensors, same mask
        qpos = kv_len - Sq + torch.arange(Sq, device="cuda")[:, None]
        kpos = torch.arange(S_max, device="cuda")[None, :]
        mask = (kpos <= qpos) & (kpos < kv_len)
        sdpa = torch.nn.functional.scaled_dot_product_attention
        lib = lambda: sdpa(q.transpose(1, 2), k.transpose(1, 2),   # noqa: E731
                           v.transpose(1, 2), attn_mask=mask,
                           enable_gqa=True)
        live = sum(min(kv_len, kv_len - Sq + i + 1) for i in range(Sq))
        nbytes = 2 * (q.numel() * 2 + B * kv_len * KH * D * 2) + 8 * B
        flops = 4 * D * H * live * B
        bms, by = bound_ms(nbytes, flops, BF16_FLOP_PER_S)
        shapes.append({
            "Sq": Sq, "kv_len": kv_len,
            "ms": cuda_ms(lambda: da.decode_attention(
                q, k, v, q_offset=off, kv_len=lens)),
            "plain_ms": cuda_ms(lambda: ref.attention(
                q, k, v, causal=True, q_offset=off, kv_len=lens)),
            "library_ms": cuda_ms(lib),
            "device_ms": device_ms(
                lambda: da.decode_attention(q, k, v, q_offset=off,
                                            kv_len=lens),
                lambda key: "decode_attention_kernel" in key),
            "bound_ms": bms, "bound_by": by})
    return {"max_abs_err": max_err, "shapes": shapes}


def check_quant(qs, ref, n_share: int) -> tuple[dict, dict]:
    """K2a/K2b at the wire's shapes, n = 16 (block 16, a decode step's
    code) and n = 1024 (block 256, a 64-token prefill's code), on one
    vector of 2**24 elements (block 256) where bandwidth shows, and at the
    sharing codec's size (one full-width stage's weights, block 256)."""
    q_shapes, d_shapes = [], []
    for n, block in [(16, 16), (1024, 256), (1 << 24, 256),
                     (n_share, 256)]:
        gen = torch.Generator(device="cuda").manual_seed(n)
        x = torch.randn(n, generator=gen, device="cuda") * 3.0
        if n // block >= 2:
            x[:block] = 0.0
        q, s = qs.quantize_int8(x, block=block)
        rq, rs = ref.quantize_int8(x, block=block)
        out = qs.dequantize_int8(q, s, block=block)
        rout = ref.dequantize_int8(rq, rs, block=block)
        torch.cuda.synchronize()
        if not (torch.equal(q, rq) and torch.equal(s, rs)):
            fail(f"quantize_int8 differs from its plain version at n={n}")
        if not torch.equal(out, rout):
            fail(f"dequantize_int8 differs from its plain version at n={n}")
        n_scales = n // block
        qb, qby = bound_ms(4 * n + n + 4 * n_scales, 6 * n, F32_FLOP_PER_S)
        db, dby = bound_ms(n + 4 * n_scales + 4 * n, n, F32_FLOP_PER_S)
        q_shapes.append({
            "n": n, "block": block,
            "ms": cuda_ms(lambda: qs.quantize_int8(x, block=block)),
            "plain_ms": cuda_ms(lambda: ref.quantize_int8(x, block=block)),
            "device_ms": device_ms(
                lambda: qs.quantize_int8(x, block=block),
                lambda key: "quantize_kernel" in key and "dequant" not in key),
            "bound_ms": qb, "bound_by": qby})
        d_shapes.append({
            "n": n, "block": block,
            "ms": cuda_ms(lambda: qs.dequantize_int8(q, s, block=block)),
            "plain_ms": cuda_ms(lambda: ref.dequantize_int8(q, s,
                                                            block=block)),
            "device_ms": device_ms(
                lambda: qs.dequantize_int8(q, s, block=block),
                lambda key: "dequantize_kernel" in key),
            "bound_ms": db, "bound_by": dby})
        del x, q, s, rq, rs, out, rout
        torch.cuda.empty_cache()
    return ({"max_abs_err": 0.0, "shapes": q_shapes},
            {"max_abs_err": 0.0, "shapes": d_shapes})


def check_flash_attention(fa, ref) -> tuple[dict, dict]:
    """K1 at the training run's shape (B 4, S 512, H 32, KH 8, D 64,
    causal) and at S 2048, forward against the plain version within one
    bf16 ulp; the autograd Function's gradients against autograd of the
    plain version (equal: the Function's backward is that autograd).
    Returns (forward, backward) records."""
    B, H, KH, D = 4, 32, 8, 64
    sdpa = torch.nn.functional.scaled_dot_product_attention
    fwd, bwd, max_err = [], [], 0.0
    for S in (512, 2048):
        gen = torch.Generator(device="cuda").manual_seed(S)
        q, k, v, g = (torch.randn(B, S, h, D, generator=gen,
                                  device="cuda").to(torch.bfloat16)
                      for h in (H, KH, KH, H))
        got = fa.flash_attention(q, k, v, causal=True)
        want = ref.attention(q, k, v, causal=True)
        torch.cuda.synchronize()
        torch.testing.assert_close(got.float(), want.float(), **ATTN_TOL)
        max_err = max(max_err, (got.float() - want.float()).abs().max()
                      .item())
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        out = fa.flash_attention(*leaves, causal=True)
        grads = torch.autograd.grad(out, leaves, g, retain_graph=True)
        pleaves = [t.clone().requires_grad_() for t in (q, k, v)]
        pgrads = torch.autograd.grad(
            ref.attention(*pleaves, causal=True), pleaves, g)
        for a, b in zip(grads, pgrads):
            if not torch.equal(a, b):
                fail(f"K1 autograd gradients differ from the plain "
                     f"version's at S={S}")
        nbytes = 2 * q.numel() * 2 + 2 * k.numel() * 2
        flops = 2 * B * H * S * S * D            # the causal half
        bms, by = bound_ms(nbytes, flops, BF16_FLOP_PER_S)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        fwd.append({
            "B": B, "S": S, "H": H, "KH": KH, "D": D, "causal": True,
            "ms": cuda_ms(lambda: fa.flash_attention(q, k, v, causal=True)),
            "device_ms": device_ms(
                lambda: fa.flash_attention(q, k, v, causal=True),
                lambda key: "flash_attention_kernel" in key, iters=20),
            "plain_ms": cuda_ms(lambda: ref.attention(q, k, v, causal=True),
                                iters=20),
            "library_ms": cuda_ms(lambda: sdpa(qt, kt, vt, is_causal=True,
                                               enable_gqa=True)),
            "bound_ms": bms, "bound_by": by})
        # the backward (autograd of the plain attention, as the
        # reference's custom_vjp); its bound: the gradients need twice the
        # forward's products (dV, dP, dQ, dK) and read/write twice its bytes
        bb, bby = bound_ms(2 * nbytes, 2 * flops, BF16_FLOP_PER_S)
        run_bwd = lambda: torch.autograd.grad(   # noqa: E731
            out, leaves, g, retain_graph=True)
        # yardstick: SDPA's own backward on the same inputs
        sleaves = [t.transpose(1, 2).detach().requires_grad_()
                   for t in (q, k, v)]
        sout = sdpa(*sleaves, is_causal=True, enable_gqa=True)
        gt = g.transpose(1, 2)
        lib_bwd = lambda: torch.autograd.grad(   # noqa: E731
            sout, sleaves, gt, retain_graph=True)
        bwd.append({
            "B": B, "S": S, "ms": cuda_ms(run_bwd, iters=10, warmup=2),
            "device_ms": device_ms(run_bwd, lambda key: True, iters=5),
            "library_ms": cuda_ms(lib_bwd, iters=10, warmup=2),
            "bound_ms": bb, "bound_by": bby})
        del q, k, v, g, got, want, leaves, out, grads, pleaves, pgrads
        del sleaves, sout, gt
        torch.cuda.empty_cache()
    return ({"max_abs_err": max_err, "shapes": fwd},
            {"max_abs_err": 0.0, "shapes": bwd})


def check_shard_merge(smk, ref, L_train: int) -> dict:
    """K3 bit for bit against its plain version at (2, 2**24) and at the
    training run's (2, L): one full-width stage's weight vector, rows on a
    64-float stride as the butterfly stacks them."""
    shapes = []
    for L in (1 << 24, L_train):
        ld = -(-L // 64) * 64
        gen = torch.Generator(device="cuda").manual_seed(L % 1000)
        shards = torch.randn(2, ld, generator=gen, device="cuda")[:, :L]
        valid = torch.ones(2, dtype=torch.bool, device="cuda")
        got = smk.shard_merge(shards, valid)
        want = ref.shard_merge(shards, valid)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            fail(f"shard_merge differs from its plain version at L={L}")
        del got, want
        bms, by = bound_ms(3 * 4 * L + 8, 2 * 2 * L, F32_FLOP_PER_S)
        shapes.append({
            "M": 2, "L": L,
            "ms": cuda_ms(lambda: smk.shard_merge(shards, valid), iters=10,
                          warmup=2),
            "device_ms": device_ms(lambda: smk.shard_merge(shards, valid),
                                   lambda key: "shard_merge" in key,
                                   iters=5),
            "plain_ms": cuda_ms(lambda: ref.shard_merge(shards, valid),
                                iters=5, warmup=1),
            "bound_ms": bms, "bound_by": by})
        del shards
        torch.cuda.empty_cache()
    return {"max_abs_err": 0.0, "shapes": shapes}


# ---------------------------------------------------------------------------
# phases 4-5: the serve path
# ---------------------------------------------------------------------------


def teacher_forced_logits(sm, spec, params, prompt, toks, wire, device):
    """Last-position logits at each step of one request whose token stream
    is ``toks``, through the stage programs on ``device``."""
    P = spec.n_stages
    progs = [sm.StageProgram(spec, s, wire, device) for s in range(P)]
    caches = [p.init_cache(1, prompt.size + len(toks)) for p in progs]
    out = []
    for i in range(len(toks)):
        h = torch.as_tensor(prompt[None], device=device) if i == 0 \
            else torch.tensor([[toks[i - 1]]], dtype=torch.int32,
                              device=device)
        for s in range(P):
            h, caches[s] = progs[s].decode_step(params[s], h, caches[s])
            if s < P - 1:
                h = progs[s + 1].decode_wire(progs[s].encode_wire(h))
        out.append(h[0, -1].float().cpu())
    return out


def reference_check(configs, sm, serve, ServeRequest, tree_to) -> dict:
    """A small llama-family model (4 layers, d_model 256, head_dim 64) on
    the card against the same weights on the CPU."""
    import dataclasses
    cfg = dataclasses.replace(
        configs.smoke_variant(configs.get("llama3.2-1b")).model,
        d_model=256, n_heads=8, n_kv_heads=2, d_head=64)
    spec = sm.SwarmModelSpec(cfg, 2)
    cpu_params = [sm.serve_stage_params(spec, 3, s, "cpu") for s in range(2)]
    gpu_params = [tree_to(p, "cuda") for p in cpu_params]
    prompts = np.random.RandomState(5).randint(3, cfg.vocab_size, (3, 12))
    decided = total = 0
    max_diff = 0.0
    for r in range(3):
        prompt = prompts[r].astype(np.int32)
        req = ServeRequest(req=r, prompt=prompt, max_new=8)
        toks = serve.swarm_generate(spec, 3, [req], wire_codec="int8",
                                    device="cpu")[r]
        cpu = teacher_forced_logits(sm, spec, cpu_params, prompt, toks,
                                    "int8", "cpu")
        gpu = teacher_forced_logits(sm, spec, gpu_params, prompt, toks,
                                    "int8", "cuda")
        for i, (c, g) in enumerate(zip(cpu, gpu)):
            if not torch.isfinite(g).all():
                fail("non-finite logits on the card")
            diff = (c - g).abs().max().item()
            max_diff = max(max_diff, diff)
            if diff > LOGIT_ATOL:
                fail(f"card logits differ from the CPU by {diff} (request "
                     f"{r}, step {i})")
            top2 = torch.topk(c, 2).values
            total += 1
            if (top2[0] - top2[1]).item() > 2 * LOGIT_ATOL:
                decided += 1
                if int(torch.argmax(g)) != toks[i]:
                    fail(f"card token differs where the CPU decided "
                         f"(request {r}, step {i})")
    return {"max_logit_diff": max_diff, "decided_steps": decided,
            "steps": total}


def serve_full_width(configs, sm, serve, ServeRequest, counters) -> dict:
    cfg = configs.get("llama3.2-1b").model
    spec = sm.SwarmModelSpec(cfg, 2)            # bottleneck_dim 16
    prompts = np.random.RandomState(0).randint(3, cfg.vocab_size, (4, 64))
    reqs = [ServeRequest(req=i, prompt=prompts[i].astype(np.int32),
                         max_new=16) for i in range(4)]
    max_len = 64 + 16
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero(counters)
    t0 = time.perf_counter()
    records = serve.serve_swarm(spec, reqs, n_lanes=2, max_len=max_len,
                                seed=0, wire_codec="int8", device="cuda")
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    launches = _read(counters)
    peak = torch.cuda.max_memory_allocated()

    for r in reqs:
        toks = records[r.req].tokens
        if len(toks) != 16 or not all(0 <= t < cfg.vocab_size for t in toks):
            fail(f"request {r.req}: bad tokens {toks}")
    need = {"decode_attention": cfg.n_layers * 16 * 4,
            "quantize_int8": 16 * 4, "dequantize_int8": 16 * 4}
    for name, least in need.items():
        if launches[name] < least:
            fail(f"{name} launched {launches[name]} times on the serve run, "
                 f"expected at least {least}")

    oracle = serve.swarm_generate(spec, 0, reqs, wire_codec="int8",
                                  device="cuda")
    for r in reqs:
        if records[r.req].tokens != oracle[r.req]:
            fail(f"request {r.req}: serve_swarm {records[r.req].tokens} != "
                 f"swarm_generate {oracle[r.req]}")

    # one full-width prefill: finite logits of the expected shape
    params = [sm.serve_stage_params(spec, 0, s, "cuda") for s in range(2)]
    progs = [sm.StageProgram(spec, s, "int8", "cuda") for s in range(2)]
    h = torch.as_tensor(prompts[:1].astype(np.int32), device="cuda")
    for s in range(2):
        h, _ = progs[s].decode_step(params[s], h, progs[s].init_cache(1, 64))
        if s == 0:
            h = progs[1].decode_wire(progs[0].encode_wire(h))
    if tuple(h.shape) != (1, 64, cfg.padded_vocab) or \
            not torch.isfinite(h).all():
        fail(f"full-width logits: shape {tuple(h.shape)}, finite "
             f"{bool(torch.isfinite(h).all())}")

    n_tok = sum(len(rec.tokens) for rec in records.values())
    start = min(rec.submit_s for rec in records.values())
    end = max(rec.done_s for rec in records.values())
    ttfts = sorted(rec.ttft for rec in records.values())
    return {"launches": launches,
            "tokens": n_tok,
            "tok_per_s": n_tok / (end - start),
            "median_ttft_ms": 1e3 * (ttfts[1] + ttfts[2]) / 2,
            "serve_swarm_s_with_weight_init": t1 - t0,
            "max_memory_allocated_bytes": peak}


def profile_serve(configs, sm, serve, ServeDriver, InProcessTransport,
                  KeySchema, ServeRequest) -> dict:
    """Where the serve run's time goes: the same 4 requests on fresh
    servers (built outside the window), driven under torch.profiler.
    Device busy time is the sum of CUDA activity (one stream, so no
    overlap); the idle share is 1 - busy / wall.  The profiler's own
    host overhead lengthens the wall time, so this reads high."""
    cfg = configs.get("llama3.2-1b").model
    spec = sm.SwarmModelSpec(cfg, 2)
    prompts = np.random.RandomState(0).randint(3, cfg.vocab_size, (4, 64))
    reqs = [ServeRequest(req=i, prompt=prompts[i].astype(np.int32),
                         max_new=16) for i in range(4)]
    servers = serve.build_servers(spec, 0, n_lanes=2, max_len=80,
                                  wire_codec="int8", device="cuda")
    driver = ServeDriver(spec, InProcessTransport(schema=KeySchema(version=5)),
                         n_lanes=2, max_len=80, servers=servers, seed=0,
                         wire_codec="int8")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    evs = device_events(lambda: driver.run(reqs))
    wall_ms = (time.perf_counter() - t0) * 1e3
    if not evs:
        return {"device_busy_ms": "not measured", "wall_ms": wall_ms}
    busy_ms = sum(e.self_device_time_total for e in evs) / 1e3
    top = sorted(evs, key=lambda e: -e.self_device_time_total)[:10]
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "device_idle_share": 1.0 - busy_ms / wall_ms,
            "top_device": [{"name": e.key[:90], "calls": e.count,
                            "ms": e.self_device_time_total / 1e3}
                           for e in top]}


# ---------------------------------------------------------------------------
# phases 7-9: the training path
# ---------------------------------------------------------------------------


def _zero(counters) -> None:
    for table in counters:
        for name in table:
            table[name] = 0


def _read(counters) -> dict:
    return {name: table[name] for table in counters for name in table}


def train_reference_check(configs, Swarm, SwarmConfig, load_swarm_state,
                          tree_map) -> dict:
    """A small llama-family swarm (4 layers, d_model 256, head_dim 64) on
    the card against the same swarm, from the same weights, on the CPU."""
    cfg = dataclasses.replace(
        configs.smoke_variant(configs.get("llama3.2-1b")).model,
        d_model=256, n_heads=8, n_kv_heads=2, d_head=64, n_layers=4)
    sc = SwarmConfig(n_stages=2, miners_per_stage=2, inner_steps=12,
                     seq_len=64, seed=0)
    cpu = Swarm.create(cfg, sc, device="cpu")
    card = Swarm.create(cfg, sc, device="cuda")
    load_swarm_state(card, [tree_map(lambda t: t.numpy(), a)
                            for a in cpu.anchors])
    want, got = cpu.run(2), card.run(2)
    torch.cuda.synchronize()
    diffs = []
    for w, g in zip(want, got):
        census = lambda st: (st.batches, st.b_eff, st.merged_stages,  # noqa
                             [(r.miner_uid, r.checked, r.passed)
                              for r in st.validation])
        if census(g) != census(w):
            fail(f"small swarm census on the card {census(g)} != CPU "
                 f"{census(w)}")
        if not np.isfinite(g.mean_loss) or \
                abs(g.mean_loss - w.mean_loss) > TRAIN_LOSS_ATOL:
            fail(f"small swarm mean loss on the card {g.mean_loss} vs CPU "
                 f"{w.mean_loss}")
        diffs.append(g.mean_loss - w.mean_loss)
    return {"mean_loss_card": [g.mean_loss for g in got],
            "mean_loss_cpu": [w.mean_loss for w in want],
            "merged_stages": [g.merged_stages for g in got],
            "max_loss_diff": max(abs(d) for d in diffs)}


TRAIN_CONFIG = dict(n_stages=2, miners_per_stage=2, inner_steps=16, b_min=4,
                    batch_size=4, seq_len=512, share_codec="int8",
                    sync_mode="dense", seed=0)


class Timed:
    """A phase that adds its wall seconds (ending in a device sync) to a
    shared table."""

    def __init__(self, phase, seconds: dict):
        self.phase, self.seconds, self.name = phase, seconds, phase.name

    def run(self, swarm, state) -> None:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        self.phase.run(swarm, state)
        torch.cuda.synchronize()
        self.seconds.setdefault(self.name, []).append(
            time.perf_counter() - t0)


def train_full_width(configs, Swarm, SwarmConfig, default_phases,
                     counters) -> tuple:
    """The training path at llama3.2-1b's published widths: 2 stages of 8
    layers, 2 miners each, 2 epochs.  Returns (record, swarm)."""
    cfg = configs.get("llama3.2-1b").model
    seconds: dict = {}
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    swarm = Swarm.create(cfg, SwarmConfig(**TRAIN_CONFIG),
                         phases=[Timed(p, seconds) for p in default_phases()],
                         device="cuda")
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    _zero(counters)
    t0 = time.perf_counter()
    stats = swarm.run(2)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _read(counters)
    peak = torch.cuda.max_memory_allocated()

    for st in stats:
        if not np.isfinite(st.mean_loss):
            fail(f"epoch {st.epoch}: mean loss {st.mean_loss}")
        for r in st.validation:
            if r.checked == 0 or r.passed != r.checked:
                fail(f"epoch {st.epoch}: honest miner {r.miner_uid} "
                     f"validated {r.passed}/{r.checked}")
    if not any(st.merged_stages >= 1 for st in stats):
        fail(f"no stage merged in {len(stats)} epochs: "
             f"{[st.batches for st in stats]}")
    for name in ("flash_attention", "shard_merge", "quantize_int8",
                 "dequantize_int8"):
        if launches[name] <= 0:
            fail(f"{name} was not launched on the training path")
    ticks = sum(TRAIN_CONFIG["inner_steps"] - st.stalled_ticks
                for st in stats)
    record = {
        "config": TRAIN_CONFIG, "epochs": len(stats),
        "mean_loss": [st.mean_loss for st in stats],
        "b_eff": [st.b_eff for st in stats],
        "merged_stages": [st.merged_stages for st in stats],
        "batches": [st.batches for st in stats],
        "validation": [[(r.miner_uid, r.checked, r.passed, r.min_cosine)
                        for r in st.validation] for st in stats],
        "agreement": [{s: a.tolist() for s, a in st.agreement.items()}
                      for st in stats],
        "swarm_init_s": t_init, "run_s": wall,
        "epoch_s": [sum(v[e] for v in seconds.values())
                    for e in range(len(stats))],
        "phase_s": seconds,
        "ticks_per_s": ticks / sum(seconds["training"]),
        "tokens_per_s": ticks * TRAIN_CONFIG["batch_size"]
        * TRAIN_CONFIG["seq_len"] / sum(seconds["training"]),
        "launches": launches,
        "max_memory_allocated_bytes": peak,
        "host_max_rss_bytes": resource.getrusage(
            resource.RUSAGE_SELF).ru_maxrss * 1024,
    }
    return record, swarm


def _profile(fn) -> dict:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    evs = device_events(fn)
    wall_ms = (time.perf_counter() - t0) * 1e3
    if not evs:
        return {"device_busy_ms": "not measured", "wall_ms": wall_ms}
    busy_ms = sum(e.self_device_time_total for e in evs) / 1e3
    top = sorted(evs, key=lambda e: -e.self_device_time_total)[:12]
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "device_idle_share": 1.0 - busy_ms / wall_ms,
            "top_device": [{"name": e.key[:90], "calls": e.count,
                            "ms": e.self_device_time_total / 1e3}
                           for e in top]}


def profile_train(swarm, EpochState, TrainingPhase, SharingPhase,
                  SyncPhase) -> dict:
    """One more training tick, then one more sharing + sync of stage 0 on
    the trained miners (their batch counts of the last epoch), the tick and
    the sync each under torch.profiler.  Busy time sums CUDA activity
    (kernels and copies on one stream); the profiler's own host cost
    lengthens the wall, so the idle share reads high."""
    config = swarm.config
    state = EpochState(epoch=swarm.epoch, snapshots={})
    try:
        swarm.config = dataclasses.replace(config, inner_steps=1)
        tick = _profile(lambda: TrainingPhase().run(swarm, state))
        # the phases walk stages 0 .. n_stages - 1: sync one stage only
        swarm.config = dataclasses.replace(config, n_stages=1)
        SharingPhase().run(swarm, state)
    finally:
        swarm.config = config
    if not state.qualified:
        return {"tick": tick, "sync": "not measured (stage 0 did not "
                                      "qualify)"}
    sync = _profile(lambda: SyncPhase().run(swarm, state))
    return {"tick": tick, "sync": sync,
            "sync_stages": sorted(state.qualified)}


def main() -> None:
    if not torch.cuda.is_available():
        fail("no CUDA device")
    name = torch.cuda.get_device_name(0)
    cap = torch.cuda.get_device_capability(0)
    smi = smi_line()
    print(f"device: {name}, capability {cap[0]}.{cap[1]}, {smi}", flush=True)
    if cap != (9, 0):
        fail(f"the kernels target sm_90a; this card is sm_{cap[0]}{cap[1]}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch import configs
    from repro_torch.api.config import SwarmConfig
    from repro_torch.api.keys import KeySchema
    from repro_torch.api.phases import (EpochState, ServeDriver,
                                        ServeRequest, SharingPhase,
                                        SyncPhase, TrainingPhase,
                                        default_phases)
    from repro_torch.api.swarm import Swarm
    from repro_torch.api.transport import InProcessTransport
    from repro_torch.common import tree_leaves, tree_map, tree_to
    from repro_torch.convert import load_swarm_state
    from repro_torch.kernels import _build, decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import quant_stream as qs, ref
    from repro_torch.kernels import shard_merge as smk
    from repro_torch.launch import serve
    from repro_torch.runtime import stage_model as sm

    t0 = time.perf_counter()
    _build.build_all(["decode_attention", "quant_stream", "flash_attention",
                      "shard_merge"])
    print(f"build: {time.perf_counter() - t0:.2f} s (nvcc, sm_90a)",
          flush=True)
    counters = [da.LAUNCHES, qs.LAUNCHES, fa.LAUNCHES, smk.LAUNCHES]

    # one full-width stage's weight vector: what sharing quantizes and the
    # butterfly merges (stage 1's, one element longer, is odd)
    train_spec = sm.SwarmModelSpec(configs.get("llama3.2-1b").model, 2)
    L_train = sum(t.numel() for t in tree_leaves(sm.init_stage_params(
        torch.Generator(device="cuda"), train_spec, 1)))
    torch.cuda.empty_cache()

    attn = check_decode_attention(da, ref)
    quant, dequant = check_quant(qs, ref, L_train - 1)
    flash, flash_bwd = check_flash_attention(fa, ref)
    merge = check_shard_merge(smk, ref, L_train)
    for label, res in (("decode_attention", attn), ("quantize_int8", quant),
                       ("dequantize_int8", dequant),
                       ("flash_attention", flash),
                       ("flash_attention_backward", flash_bwd),
                       ("shard_merge", merge)):
        print(json.dumps({"kernel": label, **res}), flush=True)

    refcheck = reference_check(configs, sm, serve, ServeRequest, tree_to)
    print(json.dumps({"reference_check": refcheck}), flush=True)

    result = serve_full_width(configs, sm, serve, ServeRequest, counters)
    print(json.dumps({"serve": {**result, "device": name, "smi": smi}}),
          flush=True)
    prof = profile_serve(configs, sm, serve, ServeDriver, InProcessTransport,
                         KeySchema, ServeRequest)
    print(json.dumps({"serve_profile": prof}), flush=True)
    torch.cuda.empty_cache()

    trainref = train_reference_check(configs, Swarm, SwarmConfig,
                                     load_swarm_state, tree_map)
    print(json.dumps({"train_reference_check": trainref}), flush=True)
    train, swarm = train_full_width(configs, Swarm, SwarmConfig,
                                    default_phases, counters)
    print(json.dumps({"train": {**train, "device": name, "smi": smi}}),
          flush=True)
    tprof = profile_train(swarm, EpochState, TrainingPhase, SharingPhase,
                          SyncPhase)
    print(json.dumps({"train_profile": tprof}), flush=True)
    del swarm

    src = "src/repro_torch/kernels/csrc/"
    # (name, checks, shape index on the path, source, replaces, the run
    # whose launches count: the path the kernel serves, or this slice's)
    plan = [
        ("decode_attention", attn, 2, "decode_attention.cu",
         "src/repro/kernels/decode_attention.py:37", result),
        ("quantize_int8", quant, 3, "quant_stream.cu",
         "src/repro/kernels/quant_stream.py:23", train),
        ("dequantize_int8", dequant, 3, "quant_stream.cu",
         "src/repro/kernels/quant_stream.py:51", train),
        ("flash_attention", flash, 0, "flash_attention.cu",
         "src/repro/kernels/flash_attention.py:33", train),
        ("shard_merge", merge, 1, "shard_merge.cu",
         "src/repro/kernels/shard_merge.py:25", train),
    ]
    kernels = []
    for kname, res, main_shape, source, replaces, run in plan:
        shp = res["shapes"][main_shape]
        kernels.append({
            "name": kname, "route": "cuda", "source": src + source,
            "replaces": replaces, "launches": run["launches"][kname],
            "launches_by_path": {"serve": result["launches"][kname],
                                 "train": train["launches"][kname]},
            "max_abs_err": res["max_abs_err"], "ms": shp["ms"],
            "device_ms": shp.get("device_ms"),
            "plain_ms": shp["plain_ms"], "bound_ms": shp["bound_ms"],
            "bound_by": shp["bound_by"],
            "library_ms": shp.get("library_ms")})
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
