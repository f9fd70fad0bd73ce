"""Serving entry point of the port: batched prefill + greedy decode over a KV
cache, and the continuous-batching scheduler front end (port of
`repro/launch/serve.py`).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-8b \
        --td td --batch 4 --prompt-len 128 --gen 16

    # ragged concurrent streams through the slot-recycling scheduler
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-8b \
        --td td --scheduler --streams 16 --capacity 8 --prompt-len 128 \
        --gen 16

run on CUDA (pass ``--device cpu`` with ``--smoke`` for a CPU run).
Parameters come from the port's seeded init, stored in the compute dtype;
prompts from ``numpy.random.default_rng``, so a test can feed the same
tokens to both packages.  A stub frontend (``--arch internvl2-26b``) or
an enc-dec model (``--arch seamless-m4t-large-v2``) also gets precomputed
embeddings, (batch, max(8, prompt_len // 2), d_frontend) in bf16, from a
numpy stream of their own (`frontend_embeds`).  Both modes print the TD
energy meter's J/token (the paper's circuit model: the three hardware
domains for the fixed batch, per request in scheduler mode).
``--td-per-layer``, ``--scenario`` and ``--corner`` resolve the operating
points as the reference does; ``--td-attn quant|td`` runs attention's
QK^T and PV on the TD engine (`tdsim.td_attention`; the fixed batch only:
the scheduler's per-row caches raise the reference's ValueError at the
first decode step).  In scheduler mode ``--adapt`` runs the drift-adaptive
engine and ``--trace SEED:STEPS[:SEGMENTS]`` or ``--trace @file.json``
replays a traffic trace through it (`ft.TrafficTrace`).
"""
from __future__ import annotations

import argparse
import contextlib
import time

import numpy as np
import torch
from torch.profiler import record_function

import repro_torch.configs as cfgs
from repro_torch import device as device_mod
from repro_torch import ft
from repro_torch.configs.base import ShapeCfg
from repro_torch.launch import sharding
from repro_torch.launch import steps as steps_lib
from repro_torch.launch import td_cli
from repro_torch.launch.scheduler import ContinuousBatchingEngine, Request
from repro_torch.models import common, get_api, matmul_shapes
from repro_torch.tdsim import energy_meter


def prompts(seed: int, batch: int, prompt_len: int, vocab: int) -> np.ndarray:
    """The prompt tokens `run` serves, (batch, prompt_len) int32."""
    rng = np.random.default_rng(seed)
    return rng.integers(3, vocab, size=(batch, prompt_len)).astype(np.int32)


def frontend_embeds(seed: int, batch: int, n: int, d: int) -> np.ndarray:
    """The stub frontend's embeddings `run` serves, (batch, n, d) float32
    standard normal (`run` rounds them to bf16, the reference's dtype),
    from a stream of their own beside that of `prompts`."""
    rng = np.random.default_rng([seed, 1])
    return rng.standard_normal((batch, n, d), dtype=np.float32)


def _full(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's whole value; a plain tensor as it is."""
    return t.full_tensor() if hasattr(t, "full_tensor") else t


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run(arch, batch: int, prompt_len: int, gen: int, seed: int = 0,
        device=None, stats: dict | None = None, mesh=None) -> torch.Tensor:
    """Serve ``batch`` prompts and return the (batch, gen) greedy tokens.
    ``stats``, when given, receives ``prefill_ms`` and ``decode_ms`` (the
    per-step list), each timed on the host clock up to a device sync, and
    with a ``logits`` list in it, the prefill's last-position logits and
    each decode step's, as full tensors.

    ``mesh`` (a `DeviceMesh` with 'data' and 'model' axes over the cards
    of the default process group) serves on it: the parameters are
    DTensors placed by `sharding.param_specs(serving=True)`, the prompts
    split over the batch by `batch_spec`, the steps run in
    `sharding.sharded_region` and the kernels on their local shards.

    A stub frontend's or an enc-dec model's prompts come with
    ``frontend_embeds(seed, batch, max(8, prompt_len // 2), d_frontend)``.
    A decoder's KV cache then also holds the frontend positions: it has
    ``n_frontend + prompt_len + gen`` rows.  The reference sizes it at
    ``prompt_len + gen`` and fails its prefill when the frontend
    positions outnumber ``gen`` (ROADMAP §3)."""
    dev = device_mod.resolve(device)
    cfg = arch.model
    pol = common.resolve_arch_policy(arch, device=dev)
    api = get_api(cfg)
    compute_dt = steps_lib.DTYPES[arch.train.compute_dtype]
    params = api["init"](seed, cfg, pol, dtype=compute_dt, device=dev)
    toks = torch.from_numpy(prompts(seed, batch, prompt_len,
                                    cfg.vocab)).to(dev)
    if mesh is not None:
        params = sharding.distribute(
            params, sharding.param_specs(params, mesh, serving=True), mesh)
        toks = sharding.distribute(
            {"t": toks}, {"t": sharding.batch_spec(mesh, batch, 2)},
            mesh)["t"]
    batch_in = {"tokens": toks}
    s_cache = prompt_len + gen
    if cfg.family == "encdec" or cfg.frontend is not None:
        n_front = max(8, prompt_len // 2)
        batch_in["embeds"] = torch.from_numpy(frontend_embeds(
            seed, batch, n_front, cfg.d_frontend or cfg.d_model)).to(
                dev, torch.bfloat16)
        if cfg.family == "decoder":
            s_cache += n_front
    shape = ShapeCfg("serve", s_cache, batch, "decode")
    keep = stats.get("logits") if stats is not None else None
    prefill = steps_lib.build_prefill_step(arch, shape, device=dev)
    serve_step = steps_lib.build_serve_step(arch, shape, device=dev,
                                            logits_out=keep)
    region = (contextlib.nullcontext() if mesh is None
              else sharding.sharded_region(mesh))

    # the spans "serve.prefill" / "serve.decode" end at a device sync, so
    # a profiler trace can assign every kernel to the step that ran it
    with torch.inference_mode(), region:
        _sync(dev)
        t0 = time.monotonic()
        with record_function("serve.prefill"):
            logits, state = prefill(params, batch_in)
            if keep is not None:
                keep.append(logits[:, -1])
            tok = common.argmax_last(logits[:, -1]).to(torch.int32)[:, None]
            _sync(dev)
        t_prefill = time.monotonic() - t0

        out_toks = [tok]
        lat = []
        for _ in range(gen - 1):
            t1 = time.monotonic()
            with record_function("serve.decode"):
                tok, state = serve_step(params, tok, state)
                _sync(dev)
            lat.append(time.monotonic() - t1)
            out_toks.append(tok)
    gen_ids = _full(torch.cat(out_toks, dim=1))
    if keep is not None:
        keep[:] = [_full(t) for t in keep]

    lat_a = np.asarray(lat) if lat else np.asarray([0.0])
    print(f"[serve] prefill({batch}x{prompt_len}): {t_prefill*1e3:.1f} ms; "
          f"decode p50={np.median(lat_a)*1e3:.1f} ms/tok "
          f"p95={np.percentile(lat_a, 95)*1e3:.1f} ms/tok ({dev})")
    print(f"[serve] sample ids[0,:16]: {gen_ids[0, :16].tolist()}")
    if stats is not None:
        stats["prefill_ms"] = t_prefill * 1e3
        stats["decode_ms"] = [t * 1e3 for t in lat]

    # the paper's energy accounting for this serving config, at the first
    # layer's policy: a solved TD policy prices at its own operating point
    # (vdd and budget, e.g. from --scenario/--corner), a quant policy at
    # the representative relaxed budget
    pol0 = common.pol_at(pol, 0)
    if pol0.mode != "precise":
        sigma_acct = None if pol0.sigma_max is not None else 2.0
        reports = energy_meter.compare_domains(matmul_shapes(cfg), pol0,
                                               sigma_max=sigma_acct,
                                               device=dev)
        for dom, rep in reports.items():
            print(f"[energy] {dom:8s}: {rep.total_energy_per_token:.3e} "
                  f"J/token over {rep.total_macs_per_token:.3e} MACs "
                  f"(vdd={pol0.vdd:.2f})")
        if stats is not None:
            stats["j_per_token"] = {d: r.total_energy_per_token
                                    for d, r in reports.items()}
    return gen_ids


def synthetic_requests(n: int, prompt_len: int, gen: int,
                       vocab: int, seed: int = 0) -> list[Request]:
    """Ragged synthetic streams: prompt and generation lengths each vary
    uniformly in [len/2, len] (the reference's numpy stream)."""
    rng = np.random.default_rng(seed)
    reqs = []
    for i in range(n):
        plen = int(rng.integers(max(1, prompt_len // 2), prompt_len + 1))
        glen = int(rng.integers(max(1, gen // 2), gen + 1))
        reqs.append(Request(
            rid=i, prompt=rng.integers(3, vocab, size=plen).astype(np.int32),
            max_new_tokens=glen))
    return reqs


def parse_trace(spec: str) -> ft.TrafficTrace:
    """``--trace`` value -> `ft.TrafficTrace`: ``@file.json`` loads a saved
    trace; ``SEED:STEPS[:SEGMENTS]`` generates a seeded one
    (`repro/launch/serve.py:112`)."""
    if spec.startswith("@"):
        return ft.TrafficTrace.load(spec[1:])
    parts = spec.split(":")
    if len(parts) not in (2, 3):
        raise ValueError("--trace wants @file.json or SEED:STEPS[:SEGMENTS]"
                         f", got {spec!r}")
    seed, steps = int(parts[0]), int(parts[1])
    n_seg = int(parts[2]) if len(parts) == 3 else 6
    return ft.TrafficTrace.generate(seed, steps, n_segments=n_seg)


def run_scheduler(arch, streams: int, prompt_len: int, gen: int,
                  capacity: int, seed: int = 0, adapt: bool = False,
                  trace=None, device=None) -> dict:
    """Continuous-batching serve: ragged streams through the scheduler,
    drift-adaptive with ``adapt`` and replaying ``trace``.  Returns the
    engine's summary."""
    eng = ContinuousBatchingEngine(arch, capacity=capacity,
                                   s_cache=prompt_len + gen, seed=seed,
                                   adapt=adapt, device=device)
    reqs = synthetic_requests(streams, prompt_len, gen, arch.model.vocab,
                              seed=seed + 1)
    t_arrival = time.monotonic()
    for r in reqs:
        r.arrival_s = t_arrival
    out = eng.run(reqs, trace=trace)
    print(f"[serve/sched] {out['requests']} requests, "
          f"{out['new_tokens']} tokens in {out['wall_s']:.2f} s "
          f"({out['tokens_per_s']:.1f} tok/s, {out['steps']} steps, "
          f"capacity {eng.capacity}, slot {eng.s_cache} tok, "
          f"{eng.device})")
    print(f"[serve/sched] per-request ms/token "
          f"p50={out['ms_per_token_p50']:.2f} "
          f"p99={out['ms_per_token_p99']:.2f}; "
          f"stragglers={out['stragglers']}")
    if "energy_j_total" in out:
        print(f"[serve/sched] TD energy: {out['energy_j_total']:.3e} J "
              f"total, {out['j_per_token']:.3e} J/token "
              f"({eng.meter.domain} domain, per-request rows available)")
    if adapt:
        print(f"[serve/sched] drift: p_x_one={out['p_x_one_measured']:.3f} "
              f"(policy anchor {common.pol_at(eng.pol, 0).p_x_one:.3f}), "
              f"{out['adaptations']} adaptation(s), "
              f"{out['supply_spans']} supply span(s)")
    if trace is not None:
        print(f"[serve/sched] trace: seed={trace.seed} "
              f"{len(trace.segments)} segment(s) / {trace.total_steps} "
              f"steps; swaps={[e['step'] for e in out['swap_log']]}")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-8b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--td", default=None,
                    choices=[None, "precise", "quant", "td"])
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; cpu for a smoke run)")
    ap.add_argument("--scheduler", action="store_true",
                    help="continuous-batching engine over ragged synthetic "
                    "streams instead of the fixed-batch driver")
    ap.add_argument("--streams", type=int, default=16,
                    help="scheduler mode: number of synthetic streams")
    ap.add_argument("--capacity", type=int, default=4,
                    help="scheduler mode: concurrent KV-cache slots")
    ap.add_argument("--td-per-layer", default=None,
                    help="heterogeneous per-layer TD policies: inline sigma "
                    "list '0.5,1.0,...' or '@per_layer_policies.json'")
    td_cli.add_scenario_args(ap)
    td_cli.add_td_attn_arg(ap)
    ap.add_argument("--adapt", action="store_true",
                    help="scheduler mode: measure activation activity in "
                    "the decode step and hot-swap the TD operating point "
                    "(policy + energy rate) when it drifts")
    ap.add_argument("--trace", default=None,
                    help="scheduler mode: replay a traffic trace through "
                    "the drift loop, @file.json or SEED:STEPS[:SEGMENTS] "
                    "(implies --adapt)")
    args = ap.parse_args(argv)
    arch = cfgs.get_smoke(args.arch) if args.smoke else cfgs.get(args.arch)
    arch = td_cli.apply_td_args(arch, args.td, args.td_per_layer,
                                args.scenario, args.corner,
                                td_attn=args.td_attn)
    if args.scheduler:
        return run_scheduler(arch, args.streams, args.prompt_len, args.gen,
                             args.capacity, seed=args.seed,
                             adapt=args.adapt or args.trace is not None,
                             trace=(parse_trace(args.trace)
                                    if args.trace else None),
                             device=args.device)
    return run(arch, args.batch, args.prompt_len, args.gen, seed=args.seed,
               device=args.device)


if __name__ == "__main__":
    main()
