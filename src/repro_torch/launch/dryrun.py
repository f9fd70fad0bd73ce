"""Dry run of a production mesh: one step of every (arch x shape) cell,
counted, not run (port of `repro/launch/dryrun.py`).

The ``fake`` process group stands in for the mesh's cards: it comes up at
the mesh's size as the process starts (this process plays rank 0; every
collective returns at once), and every tensor is a fake one (shape and
dtype, no storage).  For each cell:

  * fake parameters placed as DTensors by `launch.sharding.param_specs`
    (serving replicates them over data when the tensor-parallel copy is
    small, the reference's rule), AdamW state for a train cell,
  * fake inputs placed by `launch.specs`,
  * the port's own `steps.build_{train,prefill,serve}_step`, run once
    under `roofline.counter.Counter` inside `sharding.sharded_region`,
  * a JSON artifact with the reference's keys: ``n_params``,
    ``flops_per_chip``, ``bytes_per_chip``, ``collectives``,
    ``coll_*_total``, ``scan_corrections``, ``model_flops`` and
    ``roofline`` (`roofline.model`, the H100's data-sheet constants), and
    in place of XLA's ``memory_analysis`` a per-device ``memory``:
    parameters, optimizer state, inputs, the step's peak of live tensors
    and whether their sum fits the card's 80 GB.

Everything it reports is a model from the counted work and data-sheet
constants, not a measurement.  The kernels are counted analytically
(`roofline.counter`); the FLOPs and bytes are per device (the counter
sees the local shards).  A train cell runs one microbatch and
multiplies (``scan_corrections.micro_mult``); the microbatch count is
capped at global batch / data-parallel size, so that every microbatch
still spreads over the data axis.

CLI:
  python -m repro_torch.launch.dryrun --arch granite-8b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--multi-pod] [--mesh small]
  python -m repro_torch.launch.dryrun --arch dbrx-132b --shape train_4k --td td

``--mesh small`` is (2, n / 2) with n from ``REPRO_DRYRUN_DEVICES``
(default 8; n = 1 gives (1, 1)); ``--smoke`` runs the archs' smoke
configs.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time
import traceback

import torch

import repro_torch.configs as cfgs
from repro_torch.configs.base import TDExecCfg
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import sharding as shard_lib
from repro_torch.launch import specs as specs_lib
from repro_torch.launch import steps as steps_lib
from repro_torch.launch import td_cli
from repro_torch.models import common, get_api
from repro_torch.optim import adamw
from repro_torch.roofline import counter as counter_lib
from repro_torch.roofline import model as roofline_model


def init_fake_group(world_size: int) -> None:
    """The ``fake`` process group at ``world_size`` ranks, this process
    rank 0 (raises if one is already up at another size)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_world_size() != world_size:
            raise RuntimeError(f"a process group of {dist.get_world_size()} "
                               f"ranks is up; the mesh needs {world_size}")
        return
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)


def _local_bytes(tree) -> float:
    tot = 0.0
    for _, t in adamw.tree_leaves_with_path(tree):
        if isinstance(t, torch.Tensor):
            loc = t.to_local() if hasattr(t, "to_local") else t
            tot += loc.numel() * loc.element_size()
    return tot


def _abstract_params(arch, mesh, serving: bool = False):
    """Fake float32 parameters, placed; (params, specs)."""
    cfg = arch.model
    pol = common.resolve_arch_policy(arch, device="cpu")
    api = get_api(cfg)
    with specs_lib.fake_mode():
        params = api["init"](0, cfg, pol, device="cpu")
        specs = shard_lib.param_specs(params, mesh, serving=serving)
        return shard_lib.distribute(params, specs, mesh), specs


def _count_params(params) -> float:
    return float(sum(math.prod(t.shape)
                     for _, t in adamw.tree_leaves_with_path(params)))


def _active_params(arch, n_params: float) -> float:
    cfg = arch.model
    if cfg.moe is None:
        return n_params
    e, k = cfg.moe.num_experts, cfg.moe.top_k
    expert = 3 * cfg.d_model * cfg.moe.d_ff_expert * cfg.n_layers
    return n_params - expert * e + expert * k


def _scan_corrections(arch, shape) -> dict:
    """The reference's analytic attention cost of a cell (global, all
    chips): 4 B S_q S_kv Hq hd FLOPs and the q/k/v/o bytes in bf16 per
    attention site, x3 for train; S_q = S_kv = the step's own sequence for
    train and prefill, S_q = 1 and S_kv = seq_len for decode.  Recorded
    beside the port's own counts (the counter records each attention
    kernel call at its local shapes), which replace it in the roofline."""
    cfg = arch.model
    s = shape.seq_len
    if shape.kind == "train":
        n_micro = arch.microbatches_for(shape.name)
        s_q = s // 2 if cfg.family == "encdec" else s
    else:
        n_micro = 1
        s_q = s
    out = {"micro_mult": n_micro, "attn_flops": 0.0, "attn_bytes": 0.0}
    n_attn = sum(1 for i in range(cfg.n_layers)
                 if cfg.mixer_at(i) in ("attn", "shared_attn"))
    if cfg.family == "encdec":
        n_attn += (cfg.n_enc_layers or cfg.n_layers) + cfg.n_layers
    if n_attn == 0:
        return out
    b = shape.global_batch
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    if shape.kind == "decode":
        s_q, s_kv = 1.0, float(s)
    else:
        s_q, s_kv = float(s_q), float(s_q)
    flops = 4.0 * b * s_q * s_kv * hq * hd
    dt = 2.0
    bytes_ = dt * b * (2.0 * s_q * hq * hd + 2.0 * s_kv * hkv * hd)
    train_mult = 3.0 if shape.kind == "train" else 1.0
    out["attn_flops"] = flops * n_attn * train_mult
    out["attn_bytes"] = bytes_ * n_attn * train_mult
    return out


def cell_arch(arch_name: str, td_mode: str = "precise",
              td_per_layer: str | None = None, scenario: str | None = None,
              corner: str | None = None, td_attn: str | None = None,
              smoke: bool = False):
    arch = (cfgs.get_smoke if smoke else cfgs.get)(arch_name)
    if td_mode != "precise":
        arch = arch.replace(td=TDExecCfg(mode=td_mode))
    if td_per_layer or scenario or corner or td_attn:
        arch = td_cli.apply_td_args(arch, None, td_per_layer, scenario,
                                    corner, td_attn=td_attn)
    return arch


def run_cell(arch_name: str, shape_name: str, mesh, mesh_tag: str,
             td_mode: str = "precise", td_per_layer: str | None = None,
             scenario: str | None = None, corner: str | None = None,
             td_attn: str | None = None, smoke: bool = False) -> dict:
    arch = cell_arch(arch_name, td_mode, td_per_layer, scenario, corner,
                     td_attn, smoke)
    shape = cfgs.SHAPES[shape_name]
    chips = mesh_lib.mesh_size(mesh)
    dp = mesh_lib.dp_size(mesh)
    t0 = time.time()

    with specs_lib.fake_mode():
        params, specs = _abstract_params(arch, mesh)
        n_params = _count_params(params)
        # serving replicates the weights over 'data' when the tensor-parallel
        # copy fits comfortably per chip (dbrx-132b keeps FSDP)
        tp = mesh_lib.tp_size(mesh)
        if shape.kind == "decode" and n_params * 4 / tp < 8e9:
            params, specs = _abstract_params(arch, mesh, serving=True)
        mem = {"params_bytes": _local_bytes(params), "opt_bytes": 0.0}
        corr = _scan_corrections(arch, shape)
        cnt = counter_lib.Counter(mesh)

        if shape.kind == "train":
            n_micro = min(arch.microbatches_for(shape.name),
                          max(1, shape.global_batch // dp))
            corr["micro_mult"] = n_micro
            corr["micro_requested"] = arch.microbatches_for(shape.name)
            one = arch.replace(microbatch_by_shape={shape.name: 1})
            opt = adamw.init_opt_state(params)
            mem["opt_bytes"] = _local_bytes({"mu": opt.mu, "nu": opt.nu})
            batch = specs_lib.materialize(specs_lib.batch_specs(
                arch, shape, mesh, shape.global_batch // n_micro), mesh)
            step = steps_lib.build_train_step(one, shape, device="cpu")
            run = lambda: step(params, opt, batch, 0)       # noqa: E731
            tokens = shape.global_batch * shape.seq_len
            model_flops = roofline_model.model_flops_train(
                _active_params(arch, n_params), tokens)
        elif shape.kind == "prefill":
            batch = specs_lib.materialize(
                specs_lib.batch_specs(arch, shape, mesh), mesh)
            step = steps_lib.build_prefill_step(arch, shape, device="cpu")
            run = lambda: step(params, batch)               # noqa: E731
            tokens = shape.global_batch * shape.seq_len
            model_flops = roofline_model.model_flops_serve(
                _active_params(arch, n_params), tokens)
        else:
            batch = specs_lib.decode_input_specs(arch, shape, mesh)
            step = steps_lib.build_serve_step(arch, shape, device="cpu")
            run = lambda: step(params, batch["tok"],         # noqa: E731
                               batch["state"])
            tokens = shape.global_batch
            model_flops = roofline_model.model_flops_serve(
                _active_params(arch, n_params), tokens)
        mem["input_bytes"] = _local_bytes(batch)
        t_setup = time.time() - t0
        with cnt, shard_lib.sharded_region(mesh):
            run()
        t_step = time.time() - t0 - t_setup

    mult = corr["micro_mult"]
    kern = cnt.kernels
    k_flops = sum(k["flops"] for k in kern.values())
    k_bytes = sum(k["bytes"] for k in kern.values())
    int8 = sum(k["int_ops"] for k in kern.values())
    flops = cnt.flops + k_flops
    bytes_ = cnt.bytes + k_bytes
    coll = cnt.collectives
    by_axis = coll.link_bytes_by_axis
    corr["kernels_per_chip"] = kern
    corr["scans"] = cnt.scans
    rl = roofline_model.make_roofline(
        arch_name, shape_name, mesh_tag, chips, flops * chips * mult,
        bytes_ * chips * mult, coll.total_link_bytes * chips * mult,
        model_flops,
        coll_model_bytes_total=by_axis.get("model", 0.0) * chips * mult,
        int8_ops_total=int8 * chips * mult)
    peak = (mem["params_bytes"] + mem["opt_bytes"] + mem["input_bytes"]
            + cnt.peak_bytes)
    mem.update(peak_step_bytes=float(cnt.peak_bytes), peak_bytes=peak,
               hbm_bytes=roofline_model.HBM_BYTES,
               fits=bool(peak <= roofline_model.HBM_BYTES))
    return {
        "arch": arch_name, "shape": shape_name, "mesh": mesh_tag,
        "td_mode": td_mode, "chips": chips, "ok": True,
        "modelled": "counted work over H100 SXM data-sheet rates; "
                    "not a measurement",
        "n_params": n_params,
        "t_setup_s": round(t_setup, 2), "t_step_s": round(t_step, 2),
        "flops_per_chip": flops, "bytes_per_chip": bytes_,
        "int8_ops_per_chip": int8,
        "collectives": {
            "counts": coll.counts, "operand_bytes": coll.operand_bytes,
            "link_bytes": coll.link_bytes,
            "link_bytes_by_axis": by_axis,
        },
        "coll_operand_bytes_total": coll.total_operand_bytes,
        "coll_link_bytes_total": coll.total_link_bytes,
        "scan_corrections": corr,
        "model_flops": model_flops,
        "op_bytes_breakdown": cnt.op_bytes_breakdown(),
        "op_flops": cnt.op_flops,
        "roofline": {
            "compute_s": rl.compute_s, "memory_s": rl.memory_s,
            "collective_s": rl.collective_s, "dominant": rl.dominant,
            "step_s": rl.step_s, "mfu": rl.mfu,
            "useful_flops_ratio": rl.useful_flops_ratio,
        },
        "memory": mem,
    }


def _mesh_of(kind: str, multi_pod: bool):
    """(shape, axes, tag) of ``--mesh`` prod or small."""
    if kind == "small":
        n = int(os.environ.get("REPRO_DRYRUN_DEVICES", "8"))
        d = min(2, n)
        return (d, n // d), ("data", "model"), f"small_{d}x{n // d}"
    if multi_pod:
        return (mesh_lib.MULTI_POD_SHAPE, mesh_lib.MULTI_POD_AXES,
                "x".join(map(str, mesh_lib.MULTI_POD_SHAPE)))
    return (mesh_lib.PRODUCTION_SHAPE, mesh_lib.PRODUCTION_AXES,
            "x".join(map(str, mesh_lib.PRODUCTION_SHAPE)))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--td", default="precise",
                    choices=["precise", "quant", "td"])
    ap.add_argument("--td-per-layer", default=None,
                    help="heterogeneous per-layer TD policies: inline sigma "
                    "list '0.5,1.0,...' or '@per_layer_policies.json'")
    td_cli.add_td_attn_arg(ap)
    td_cli.add_scenario_args(ap)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--mesh", default="prod", choices=["prod", "small"])
    ap.add_argument("--smoke", action="store_true",
                    help="the archs' reduced smoke configs")
    ap.add_argument("--out", default="artifacts/dryrun")
    args = ap.parse_args(argv)

    shape, axes, mesh_tag = _mesh_of(args.mesh, args.multi_pod)
    init_fake_group(math.prod(shape))
    mesh = mesh_lib.make_mesh(shape, axes, device="cpu")

    os.makedirs(args.out, exist_ok=True)
    cells = ([(args.arch, args.shape, False)] if not args.all
             else cfgs.cells(include_skips=False))

    n_ok = n_fail = 0
    for arch_name, shape_name, _ in cells:
        tag = f"{arch_name}__{shape_name}__{mesh_tag}" + \
            ("__smoke" if args.smoke else "") + \
            (f"__{args.td}" if args.td != "precise" else "") + \
            ("__per_layer" if args.td_per_layer else "") + \
            (f"__attn-{args.td_attn}" if args.td_attn else "") + \
            (f"__{args.scenario}" if args.scenario else "") + \
            (f"__{args.corner}" if args.corner else "")
        out_path = os.path.join(args.out, tag + ".json")
        t0 = time.time()
        try:
            res = run_cell(arch_name, shape_name, mesh, mesh_tag, args.td,
                           td_per_layer=args.td_per_layer,
                           scenario=args.scenario, corner=args.corner,
                           td_attn=args.td_attn, smoke=args.smoke)
            n_ok += 1
            m = res["memory"]
            print(f"[OK] {tag}: dominant={res['roofline']['dominant']} "
                  f"step={res['roofline']['step_s']:.6g}s "
                  f"mfu={res['roofline']['mfu']:.4f} "
                  f"peak={m['peak_bytes'] / 1e9:.3f}GB fits={m['fits']} "
                  f"wall={time.time() - t0:.2f}s (modelled, H100 data "
                  "sheet)", flush=True)
        except Exception as e:  # noqa: BLE001
            n_fail += 1
            res = {"arch": arch_name, "shape": shape_name, "mesh": mesh_tag,
                   "td_mode": args.td, "ok": False, "error": repr(e),
                   "traceback": traceback.format_exc()}
            print(f"[FAIL] {tag}: {e!r}", flush=True)
        res["wall_s"] = round(time.time() - t0, 3)
        with open(out_path, "w") as f:
            json.dump(res, f, indent=1)
    print(f"dry-run complete: {n_ok} ok, {n_fail} failed")
    if n_fail:
        raise SystemExit(1)


if __name__ == "__main__":
    main(sys.argv[1:])
