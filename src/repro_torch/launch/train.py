"""End-to-end training driver of the port (port of `repro/launch/train.py`).

    PYTHONPATH=src python -m repro_torch.launch.train --smoke --td td \
        --steps 3

runs on CUDA (pass ``--device cpu`` for a CPU run).  Wires together: config
registry -> model zoo -> TD execution policy -> synthetic data pipeline
(prefetch) -> train_step (gradient accumulation + AdamW) -> async
checkpoints (`checkpoint.ckpt`, ``--ckpt-dir``) -> watchdog/retry fault
tolerance.  Parameters come from the port's seeded init in float32, or
from the newest intact checkpoint.  ``--td-per-layer``, ``--scenario`` and
``--corner`` resolve the TD operating points as the reference does
(`launch.td_cli`), and ``--td-attn quant|td`` runs attention on the TD
engine (`tdsim.td_attention`, straight-through gradients).  A stub
frontend (``--arch internvl2-26b``) or an enc-dec model (``--arch
seamless-m4t-large-v2``) gets each step's precomputed embeddings from
`SyntheticStream.frontend_batch` (float32, ``max(4, min(16, seq // 4))``
positions), as in the reference.  `run` also consumes a chaos
`ft.FaultSchedule` (stalls, checkpoint corruption, preemptions).
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch
from torch.profiler import record_function

import repro_torch.configs as cfgs
from repro_torch import device as device_mod
from repro_torch import ft
from repro_torch.checkpoint import ckpt
from repro_torch.configs.base import ShapeCfg
from repro_torch.data.pipeline import PrefetchLoader
from repro_torch.data.synthetic import DataCfg, SyntheticStream
from repro_torch.launch import steps as steps_lib
from repro_torch.launch import td_cli
from repro_torch.models import common, get_api
from repro_torch.optim import adamw


def build_session(arch, shape, ckpt_dir, seed=0, device=None):
    """(params, opt_state, train_step, start_step): the seeded init, or
    the newest intact checkpoint in ``ckpt_dir``; a directory whose every
    step fails verification starts cold (from the init) rather than
    failing."""
    dev = device_mod.resolve(device)
    cfg = arch.model
    pol = common.resolve_arch_policy(arch, device=dev)
    params = get_api(cfg)["init"](seed, cfg, pol, device=dev)
    opt_state = adamw.init_opt_state(params)
    start_step = 0
    if ckpt_dir and ckpt.latest_steps(ckpt_dir):
        try:
            start_step, (params, opt_state), _ = ckpt.restore(
                ckpt_dir, (params, opt_state), device=dev)
            print(f"[train] resumed from step {start_step}")
        except ckpt.CorruptCheckpoint as e:
            print(f"[train] no intact checkpoint, cold start: {e}")
    return (params, opt_state,
            steps_lib.build_train_step(arch, shape, device=dev), start_step)


def _to_device(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    t = torch.from_numpy(a)
    if dev.type == "cuda":
        # pinned source: the copy does not wait for the device
        return t.pin_memory().to(dev, non_blocking=True)
    return t.to(dev)


def frontend_inputs(batch: dict, stream: SyntheticStream, step: int, cfg,
                    device) -> dict:
    """Step ``step``'s batch with a stub frontend's inputs, as the
    reference's driver builds them: ``max(4, min(16, seq // 4))``
    positions of precomputed embeddings from ``stream`` (float32, on
    ``device``); a decoder's tokens and labels are cut to make room for
    them, an enc-dec model's encoder reads them beside all the tokens.  A
    model without a frontend gets ``batch`` as it is."""
    if cfg.frontend is None:
        return batch
    n_vis = max(4, min(16, batch["tokens"].shape[1] // 4))
    batch = {**batch, "embeds": _to_device(stream.frontend_batch(
        step, n_vis, cfg.d_frontend or cfg.d_model), device)}
    if cfg.family != "encdec":
        batch["tokens"] = batch["tokens"][:, :-n_vis]
        batch["labels"] = batch["labels"][:, n_vis:]
    return batch


def run(arch, shape: ShapeCfg, steps: int, ckpt_dir: str | None,
        ckpt_every: int = 50, log_every: int = 10, seed: int = 0,
        fail_at: int | None = None, schedule: "ft.FaultSchedule | None" = None,
        record: dict | None = None, device=None, stats: dict | None = None):
    """One train session from the latest checkpoint to ``steps``; returns
    (params, losses of this session's steps).

    Every ``ckpt_every`` steps the parameters and optimizer state are
    saved asynchronously into ``ckpt_dir`` (if given).  ``schedule``
    injects a `ft.FaultSchedule` (fire once): preemptions raise through to
    the caller's `ft.run_with_retries`, stalls sleep before the step,
    ``ckpt_corrupt`` corrupts the newest published checkpoint (after
    joining a save in flight, so it lands on a whole one), and the next
    session restores from the last intact step.  ``record``, when given,
    is filled in place: ``starts`` (the resume step of each session) and
    ``faults`` ((step, kind) fired).  ``stats`` receives per step
    ``step_s`` (host clock up to the loss's device sync) and
    ``grad_norm``.  Each step runs inside a "train.step" span that ends at
    that sync."""
    cfg = arch.model
    dev = device_mod.resolve(device)
    params, opt_state, train_step, start = build_session(
        arch, shape, ckpt_dir, seed, dev)
    if record is not None:
        record.setdefault("starts", []).append(start)
        record.setdefault("faults", [])
    stream = SyntheticStream(
        DataCfg(vocab=cfg.vocab, seq_len=shape.seq_len,
                global_batch=shape.global_batch, seed=seed))
    loader = PrefetchLoader(stream, start_step=start)
    watchdog = ft.StepWatchdog()
    pending_save = None
    losses = []
    try:
        for i in range(start, steps):
            step_idx, host_batch = loader.get()
            assert step_idx == i
            batch = frontend_inputs(
                {k: _to_device(v, dev) for k, v in host_batch.items()},
                stream, i, cfg, dev)
            if fail_at is not None and i == fail_at:
                raise ft.Preemption(f"injected failure at step {i}")
            if schedule is not None:
                for ev in schedule.pop(i):
                    if record is not None:
                        record["faults"].append((i, ev.kind))
                    if ev.kind == "stall":
                        time.sleep(float(ev.params.get("duration_s", 0.05)))
                    elif ev.kind == "ckpt_corrupt" and ckpt_dir:
                        if pending_save is not None:
                            pending_save.join()
                            pending_save = None
                        ft.corrupt_checkpoint(
                            ckpt_dir, ev.params.get("mode", "bitflip"),
                            seed=int(ev.params.get("seed", 0)))
                    elif ev.kind == "preempt":
                        raise ft.Preemption(f"chaos preempt at step {i}")
                    # drift / explorer_outage target serving
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
            if ckpt_dir and (i + 1) % ckpt_every == 0:
                if pending_save is not None:
                    pending_save.join()
                pending_save = ckpt.save(ckpt_dir, i + 1,
                                         (params, opt_state),
                                         meta={"arch": cfg.name})
    finally:
        loader.close()
        if pending_save is not None:
            pending_save.join()
    return params, losses


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
    ap.add_argument("--ckpt-dir", default=None,
                    help="save every 50 steps here and resume from the "
                    "newest intact step")
    args = ap.parse_args(argv)

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
