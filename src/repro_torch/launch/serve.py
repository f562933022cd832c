"""Serving the swarm: the sequential oracle and the pipelined driver
(mirrors the swarm part of ``repro/launch/serve.py``).

  swarm_generate  the sequential oracle of the stage-sharded serve plane:
                  each request runs alone through every ``StageProgram``
                  in stage order, with the same stage parameters, boundary
                  codec round trips and sampling generators as the driver.
  serve_swarm     ``ServeDriver`` running the compiled decode timetable
                  with continuous batching over the in-process store.

Greedy parity contract: at the same seed, ``serve_swarm`` emits tokens
bit-identical to ``swarm_generate`` for every stage count and admission
order.

Entry points compute on ``device``, by default the CUDA card; without a
card they raise rather than carry on on the CPU (pass ``device="cpu"`` to
run on the host).  The socket store and actor fleets come with the
multi-process slice, the dense ``generate`` path with the model-zoo slice.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.serve --swarm --stages 2 \\
      --lanes 2 --wire-codec int8
  PYTHONPATH=src python -m repro_torch.launch.serve --swarm --smoke \\
      --device cpu
"""
from __future__ import annotations

import argparse
import time
from typing import Iterable

import numpy as np
import torch

from repro_torch import configs
from repro_torch.common import generator, use_full_f32_matmul


def resolve_device(device: str) -> str:
    """Check that ``device`` is usable and set the f32 matmul policy.
    A CUDA device without a card raises: nothing falls back to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {device!r} requested but no CUDA device is present "
                f"(pass device='cpu' to run on the host)")
        use_full_f32_matmul()
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}")
    return str(dev)


def swarm_generate(spec, seed: int, requests: Iterable, *,
                   wire_codec: str = "none", device: str = "cuda") -> dict:
    """Sequential oracle for the stage-sharded serve plane.

    Each request runs alone, token by token, through every stage in
    order: the whole prompt at step 0, then one ``decode_step`` per
    emitted token, crossing each stage boundary through the same
    ``encode_wire``/``decode_wire`` round trip the store path uses and
    sampling with the same ``request_key(seed, req, index)`` generator.
    Returns ``{req: [token, ...]}``."""
    from repro_torch.runtime import stage_model as sm

    device = resolve_device(device)
    P = spec.n_stages
    programs = [sm.StageProgram(spec, s, wire_codec, device) for s in range(P)]
    params = [sm.serve_stage_params(spec, seed, s, device) for s in range(P)]
    out: dict = {}
    for r in requests:
        prompt = torch.as_tensor(np.asarray(r.prompt, np.int32).reshape(1, -1),
                                 device=device)
        caches = [programs[s].init_cache(1, prompt.shape[1] + r.max_new)
                  for s in range(P)]
        toks: list = []
        for i in range(r.max_new):
            h = prompt if i == 0 else torch.tensor(
                [[toks[-1]]], dtype=torch.int32, device=device)
            for s in range(P):
                h, caches[s] = programs[s].decode_step(params[s], h,
                                                       caches[s])
                if s < P - 1:
                    h = programs[s + 1].decode_wire(
                        programs[s].encode_wire(h))
            toks.append(int(sm.sample_token(
                h[:, -1], temperature=r.temperature,
                gen=sm.request_key(seed, r.req, i))[0]))
        out[r.req] = toks
    return out


def build_servers(spec, seed: int, *, n_lanes: int, max_len: int,
                  wire_codec: str = "none", device: str = "cuda") -> list:
    """One ``StageServer`` per stage, with parameters derived from the
    session seed."""
    from repro_torch.api.phases import StageServer
    from repro_torch.runtime import stage_model as sm

    device = resolve_device(device)
    return [StageServer(spec, s, sm.serve_stage_params(spec, seed, s, device),
                        n_lanes=n_lanes, max_len=max_len,
                        wire_codec=wire_codec, device=device)
            for s in range(spec.n_stages)]


def serve_swarm(spec, requests: list, *, n_lanes: int, max_len: int,
                transport: str = "inprocess", seed: int = 0,
                wire_codec: str = "none", device: str = "cuda") -> dict:
    """Serve ``requests`` over the decode pipeline; returns
    ``{req: RequestRecord}``.  ``transport="inprocess"``: an in-memory
    store, with the driver executing every timetable slot."""
    from repro_torch.api.keys import KeySchema
    from repro_torch.api.phases import ServeDriver
    from repro_torch.api.transport import InProcessTransport

    if transport in ("socket", "actors"):
        raise NotImplementedError(
            f"transport {transport!r} comes with the multi-process slice "
            f"(serde, socket store, actor fleets)")
    if transport != "inprocess":
        raise ValueError(f"unknown serve transport {transport!r}")
    driver = ServeDriver(
        spec, InProcessTransport(schema=KeySchema(version=5)),
        n_lanes=n_lanes, max_len=max_len, seed=seed, wire_codec=wire_codec,
        servers=build_servers(spec, seed, n_lanes=n_lanes, max_len=max_len,
                              wire_codec=wire_codec, device=device))
    return driver.run(requests)


def _summarize(records: dict, t0: float, t1: float) -> None:
    n_tok = sum(len(r.tokens) for r in records.values())
    ttfts = sorted(r.ttft for r in records.values() if r.ttft is not None)
    print(f"served {len(records)} requests, {n_tok} tokens in "
          f"{t1 - t0:.2f}s ({n_tok / (t1 - t0):.1f} tok/s), "
          f"median ttft {ttfts[len(ttfts) // 2] * 1e3:.1f}ms")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--swarm", action="store_true",
                    help="serve over the stage-sharded decode pipeline (the "
                         "only mode this slice has)")
    ap.add_argument("--stages", type=int, default=2)
    ap.add_argument("--lanes", type=int, default=2)
    ap.add_argument("--wire-codec", default="none", choices=("none", "int8"))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--no-parity-check", action="store_true",
                    help="skip the greedy-parity check against the "
                         "sequential oracle (temperature 0)")
    args = ap.parse_args(argv)

    if not args.swarm:
        raise SystemExit("the dense generate path comes with the model-zoo "
                         "slice; pass --swarm")
    cfg = configs.get(args.arch)
    if args.smoke:
        cfg = configs.smoke_variant(cfg)

    from repro_torch.api.phases import ServeRequest
    from repro_torch.runtime import stage_model as sm

    if cfg.model.n_layers % args.stages:
        raise SystemExit("--stages must divide the model's layer count")
    spec = sm.SwarmModelSpec(cfg.model, args.stages)
    prompts = torch.randint(
        3, cfg.model.vocab_size, (args.requests, args.prompt_len),
        generator=generator("cpu", "prompts", args.seed), dtype=torch.int32)
    requests = [ServeRequest(req=i, prompt=prompts[i].numpy(),
                             max_new=args.max_new,
                             temperature=args.temperature)
                for i in range(args.requests)]
    t0 = time.perf_counter()
    records = serve_swarm(spec, requests, n_lanes=args.lanes,
                          max_len=args.prompt_len + args.max_new,
                          seed=args.seed, wire_codec=args.wire_codec,
                          device=args.device)
    if torch.device(args.device).type == "cuda":
        torch.cuda.synchronize()
    t1 = time.perf_counter()
    _summarize(records, t0, t1)
    if args.temperature <= 0 and not args.no_parity_check:
        oracle = swarm_generate(spec, args.seed, requests,
                                wire_codec=args.wire_codec,
                                device=args.device)
        for i in sorted(records):
            if records[i].tokens != oracle[i]:
                raise SystemExit(f"parity violation on request {i}")
        print(f"greedy parity vs sequential oracle: OK "
              f"({len(records)} requests)")
    return records


if __name__ == "__main__":
    main()
