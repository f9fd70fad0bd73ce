"""Serving entry point of the port: batched prefill + greedy decode over a KV
cache (port of the fixed-batch path of `repro/launch/serve.py`).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-8b \
        --td td --batch 4 --prompt-len 128 --gen 16

runs on CUDA (pass ``--device cpu`` with ``--smoke`` for a CPU run).
Parameters come from the port's seeded init, stored in the compute dtype;
prompts from ``numpy.random.default_rng(seed)``, so a test can feed the
same tokens to both packages.  The continuous-batching scheduler, drift
adaptation and the energy meter are not ported yet: their flags raise.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch
from torch.profiler import record_function

import repro_torch.configs as cfgs
from repro_torch import device as device_mod
from repro_torch.configs.base import ShapeCfg
from repro_torch.launch import steps as steps_lib
from repro_torch.launch import td_cli
from repro_torch.models import common, get_api


def prompts(seed: int, batch: int, prompt_len: int, vocab: int) -> np.ndarray:
    """The prompt tokens `run` serves, (batch, prompt_len) int32."""
    rng = np.random.default_rng(seed)
    return rng.integers(3, vocab, size=(batch, prompt_len)).astype(np.int32)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run(arch, batch: int, prompt_len: int, gen: int, seed: int = 0,
        device=None, stats: dict | None = None) -> torch.Tensor:
    """Serve ``batch`` prompts and return the (batch, gen) greedy tokens.
    ``stats``, when given, receives ``prefill_ms`` and ``decode_ms`` (the
    per-step list), each timed on the host clock up to a device sync."""
    dev = device_mod.resolve(device)
    cfg = arch.model
    pol = common.resolve_arch_policy(arch)
    api = get_api(cfg)
    compute_dt = steps_lib.DTYPES[arch.train.compute_dtype]
    params = api["init"](seed, cfg, pol, dtype=compute_dt, device=dev)
    s_cache = prompt_len + gen
    shape = ShapeCfg("serve", s_cache, batch, "decode")
    prefill = steps_lib.build_prefill_step(arch, shape)
    serve_step = steps_lib.build_serve_step(arch, shape)
    toks = torch.from_numpy(prompts(seed, batch, prompt_len,
                                    cfg.vocab)).to(dev)

    # the spans "serve.prefill" / "serve.decode" end at a device sync, so
    # a profiler trace can assign every kernel to the step that ran it
    with torch.inference_mode():
        _sync(dev)
        t0 = time.monotonic()
        with record_function("serve.prefill"):
            logits, state = prefill(params, {"tokens": toks})
            tok = torch.argmax(logits[:, -1], -1).to(torch.int32)[:, None]
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
    gen_ids = torch.cat(out_toks, dim=1)

    lat_a = np.asarray(lat) if lat else np.asarray([0.0])
    print(f"[serve] prefill({batch}x{prompt_len}): {t_prefill*1e3:.1f} ms; "
          f"decode p50={np.median(lat_a)*1e3:.1f} ms/tok "
          f"p95={np.percentile(lat_a, 95)*1e3:.1f} ms/tok ({dev})")
    print(f"[serve] sample ids[0,:16]: {gen_ids[0, :16].tolist()}")
    if stats is not None:
        stats["prefill_ms"] = t_prefill * 1e3
        stats["decode_ms"] = [t * 1e3 for t in lat]
    return gen_ids


_NOT_PORTED = ("scheduler", "adapt", "trace", "td_per_layer", "td_attn",
               "scenario", "corner")


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
    # flags of the reference's CLI that this port does not run yet
    ap.add_argument("--scheduler", action="store_true")
    ap.add_argument("--streams", type=int, default=None)
    ap.add_argument("--capacity", type=int, default=None)
    ap.add_argument("--adapt", action="store_true")
    ap.add_argument("--trace", default=None)
    ap.add_argument("--td-per-layer", default=None)
    ap.add_argument("--td-attn", default=None)
    ap.add_argument("--scenario", default=None)
    ap.add_argument("--corner", default=None)
    args = ap.parse_args(argv)
    given = [f for f in _NOT_PORTED + ("streams", "capacity")
             if getattr(args, f) not in (None, False)]
    if given:
        raise NotImplementedError(
            f"--{given[0].replace('_', '-')} is not yet ported to "
            "repro_torch (ROADMAP.md §1)")
    arch = cfgs.get_smoke(args.arch) if args.smoke else cfgs.get(args.arch)
    arch = td_cli.apply_td_args(arch, args.td)
    return run(arch, args.batch, args.prompt_len, args.gen, seed=args.seed,
               device=args.device)


if __name__ == "__main__":
    main()
