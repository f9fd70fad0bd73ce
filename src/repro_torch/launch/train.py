"""End-to-end training driver of the port (port of `repro/launch/train.py`).

    PYTHONPATH=src python -m repro_torch.launch.train --smoke --td td \
        --steps 3

runs on CUDA (pass ``--device cpu`` for a CPU run).  Wires together: config
registry -> model zoo -> TD execution policy -> synthetic data pipeline
(prefetch) -> train_step (gradient accumulation + AdamW) -> watchdog/retry
fault tolerance.  Parameters come from the port's seeded init in float32.
``--td-per-layer``, ``--scenario`` and ``--corner`` resolve the TD
operating points as the reference does (`launch.td_cli`), and
``--td-attn quant|td`` runs attention on the TD engine
(`tdsim.td_attention`, straight-through gradients); checkpointing
(``--ckpt-dir``) and chaos schedules are not ported yet: they raise.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch
from torch.profiler import record_function

import repro_torch.configs as cfgs
from repro_torch import device as device_mod
from repro_torch import ft
from repro_torch.configs.base import ShapeCfg
from repro_torch.data.pipeline import PrefetchLoader
from repro_torch.data.synthetic import DataCfg, SyntheticStream
from repro_torch.launch import steps as steps_lib
from repro_torch.launch import td_cli
from repro_torch.models import common, get_api
from repro_torch.optim import adamw


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not yet ported to repro_torch "
                               "(ROADMAP.md §1)")


def build_session(arch, shape, ckpt_dir, seed=0, device=None):
    """(params, opt_state, train_step, start_step) of a fresh session."""
    if ckpt_dir:
        raise _not_ported("checkpointing (--ckpt-dir)")
    dev = device_mod.resolve(device)
    cfg = arch.model
    pol = common.resolve_arch_policy(arch, device=dev)
    params = get_api(cfg)["init"](seed, cfg, pol, device=dev)
    opt_state = adamw.init_opt_state(params)
    return (params, opt_state,
            steps_lib.build_train_step(arch, shape, device=dev), 0)


def _to_device(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    t = torch.from_numpy(a)
    if dev.type == "cuda":
        # pinned source: the copy does not wait for the device
        return t.pin_memory().to(dev, non_blocking=True)
    return t.to(dev)


def run(arch, shape: ShapeCfg, steps: int, ckpt_dir: str | None,
        log_every: int = 10, seed: int = 0, schedule=None, device=None,
        stats: dict | None = None):
    """One train session from step 0 to ``steps``; returns (params,
    losses).  ``stats``, when given, receives per step ``step_s`` (host
    clock up to the loss's device sync) and ``grad_norm``.  Each step runs
    inside a "train.step" span that ends at that sync."""
    if schedule is not None:
        raise _not_ported("chaos fault schedules (ft.chaos)")
    cfg = arch.model
    dev = device_mod.resolve(device)
    params, opt_state, train_step, start = build_session(
        arch, shape, ckpt_dir, seed, dev)
    stream = SyntheticStream(
        DataCfg(vocab=cfg.vocab, seq_len=shape.seq_len,
                global_batch=shape.global_batch, seed=seed))
    loader = PrefetchLoader(stream, start_step=start)
    watchdog = ft.StepWatchdog()
    losses = []
    try:
        for i in range(start, steps):
            step_idx, host_batch = loader.get()
            assert step_idx == i
            batch = {k: _to_device(v, dev) for k, v in host_batch.items()}
            watchdog.start(i)
            with record_function("train.step"):
                params, opt_state, metrics = train_step(
                    params, opt_state, batch, i)
                loss = float(metrics["loss"])
            rep = watchdog.stop()
            losses.append(loss)
            if stats is not None:
                stats.setdefault("step_s", []).append(rep.duration)
                stats.setdefault("grad_norm", []).append(
                    float(metrics["grad_norm"]))
            if rep.is_straggler:
                print(f"[watchdog] step {i} straggler: "
                      f"{rep.duration:.2f}s vs p50 {rep.p50:.2f}s")
            if i % log_every == 0:
                print(f"[train] step {i} loss={loss:.4f} "
                      f"gnorm={float(metrics['grad_norm']):.3f} "
                      f"lr={float(metrics['lr']):.2e} "
                      f"({rep.duration:.2f}s)")
    finally:
        loader.close()
    return params, losses


_NOT_PORTED = ("ckpt_dir",)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-8b")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--td", default=None,
                    choices=[None, "precise", "quant", "td"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; cpu for a smoke run)")
    ap.add_argument("--td-per-layer", default=None,
                    help="heterogeneous per-layer TD policies: inline sigma "
                    "list '0.5,1.0,...' or '@per_layer_policies.json'")
    td_cli.add_scenario_args(ap)
    td_cli.add_td_attn_arg(ap)
    # a flag of the reference's CLI that this port does not run yet
    ap.add_argument("--ckpt-dir", default=None)
    args = ap.parse_args(argv)
    given = [f for f in _NOT_PORTED if getattr(args, f) is not None]
    if given:
        raise _not_ported(f"--{given[0].replace('_', '-')}")

    arch = cfgs.get_smoke(args.arch) if args.smoke else cfgs.get(args.arch)
    arch = td_cli.apply_td_args(arch, args.td, args.td_per_layer,
                                args.scenario, args.corner,
                                td_attn=args.td_attn)
    shape = ShapeCfg("cli", args.seq, args.batch, "train")

    def session():
        return run(arch, shape, args.steps, args.ckpt_dir, seed=args.seed,
                   device=args.device)

    _, losses = ft.run_with_retries(
        session, on_restart=lambda n, e: print(f"[ft] restart {n}: {e!r}"))
    n = max(1, len(losses) // 5)
    print(f"[train] done. loss first-5-avg={np.mean(losses[:n]):.4f} "
          f"last-5-avg={np.mean(losses[-n:]):.4f}")
    return losses


if __name__ == "__main__":
    main()
