"""Worker of tests/test_torch_mesh_gloo.py (not a test module): the port's
sharding on real CPU processes, the gloo backend over a `FileStore`.

    python tests/torch_mesh_worker.py DIR 4    # 4 ranks: (2, 2) and (4, 1)
    python tests/torch_mesh_worker.py DIR 1    # 1 rank: the (1, 1) search
    python tests/torch_mesh_worker.py DIR 4 scan   # the stacked layout
    python tests/torch_mesh_worker.py DIR 4 embed  # the sharded lookup's gradient
    python tests/torch_mesh_worker.py DIR 4 train  # a sharded train step

Each rank writes ``DIR/rank<r>.json``.  Four ranks check: the smoke
decoder's forward with parameters placed by `param_specs` on a (2, 2)
mesh against the unsharded forward (f32, rtol 1e-5); the batched search
with ``mesh=`` (4, 1), whole and chunked, against the unsharded one, bit
for bit; a checkpoint restored onto placements, bit for bit.  One rank
writes the searches of `probe_eval` on a (1, 1) mesh, for the test to
hold against the reference's `TestMeshShardedProbes`, and serves the
smoke qwen3-8b on it against the plain serve.  With ``scan``, four ranks
serve the stacked (``scan_layers``) smoke qwen3-8b on a (2, 2) mesh
against the unsharded stacked serve and the unrolled serve on the mesh,
and restore a stacked checkpoint onto placements.  With ``embed``, four
ranks take the gradients of a loss over the smoke-sized embedding table
(vocab 128, d_model 64, placed by `param_specs`) and an lm_head on a (2,
2) mesh, at 4 x 4096 ids: DTensor then splits the table over its
vocabulary, and the gradients must equal the unsharded ones.  With
``train``, four ranks run the smoke granite-8b's f32 loss, backward and
one AdamW update at 4 x 512 tokens on a (2, 2) mesh, for the test to
hold against the same step unsharded.
"""
import json
import os
import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

SEARCH = dict(sigmas=[0.5, 2.0, 8.0], n_layers=1, n_repeats=2)


def probe_eval(sigma_vecs, keys):
    """The reference's `_probe_eval` (tests/test_td_vmm_engine.py:197-204)
    over a batch of probes: td_vmm of fixed codes at each probe's sigma
    and key, 1 / (1 + mean |y|)."""
    from repro_torch.kernels.td_vmm import ops as td_ops
    from repro_torch.tdsim.policy import TDPolicy
    xi = torch.arange(32, dtype=torch.int32).reshape(2, 16) % 8 - 4
    wi = torch.arange(64, dtype=torch.int32).reshape(16, 4) % 8 - 4
    out = []
    for sv, k in zip(sigma_vecs.tolist(), keys):
        pol = TDPolicy(mode="td", bits_a=4, bits_w=4, n_chain=16,
                       sigma_chain=float(sv[0]), tdc_q=1)
        y = td_ops.td_vmm(xi, wi, pol, k)
        out.append(1.0 / (1.0 + y.abs().mean()))
    return torch.stack(out)


def layered_eval(sigma_vecs, keys):
    """A three-layer eval whose accuracy falls with each layer's sigma at
    its own rate, noisy through td_vmm."""
    w = torch.tensor([1.0, 0.5, 0.25])
    return probe_eval((sigma_vecs * w).sum(1, keepdim=True), keys)


def _result(res) -> dict:
    return {k: np.asarray(getattr(res, k)).tolist()
            for k in ("rel_drop", "sigma_max", "acc_clean")}


def _same(a, b) -> bool:
    return all(np.array_equal(np.asarray(getattr(a, k)),
                              np.asarray(getattr(b, k)))
               for k in ("rel_drop", "sigma_max", "acc_clean"))


def run(rank: int, world: int, out: str, mode: str = "") -> None:
    torch.set_num_threads(1)
    store = dist.FileStore(os.path.join(out, "store"), world)
    dist.init_process_group("gloo", store=store, rank=rank,
                            world_size=world)
    from repro_torch import prng
    from repro_torch.core import noise_tolerance as nt
    from repro_torch.launch import mesh as mesh_lib
    doc: dict = {}
    key = prng.key(0)
    if mode == "scan":
        doc.update(_scan_serve(mesh_lib))
        doc.update(_restore(mesh_lib, out, rank, scan=True))
    elif mode == "embed":
        doc.update(_embed_grad(mesh_lib))
    elif mode == "train":
        doc.update(_train(mesh_lib))
    elif world == 1:
        mesh = mesh_lib.make_mesh((1, 1), ("data", "model"), device="cpu")
        kw = dict(SEARCH, key=key, device="cpu")
        for name, extra in [("plain", {}), ("meshed", {"mesh": mesh}),
                            ("chunked", {"mesh": mesh, "chunk_size": 3})]:
            doc[name] = _result(nt.find_sigma_max_batched(probe_eval, **kw,
                                                          **extra))
        doc["serve"] = _serve(mesh)
    else:
        doc.update(_forward(mesh_lib))
        mesh41 = mesh_lib.make_mesh((4, 1), ("data", "model"), device="cpu")
        kw = dict(sigmas=[0.25, 1.0, 4.0, 8.0], key=key, n_layers=3,
                  n_repeats=2, device="cpu")
        plain = nt.find_sigma_max_batched(layered_eval, **kw)
        doc["search_eq"] = {
            f"chunk {c}": _same(plain, nt.find_sigma_max_batched(
                layered_eval, **kw, mesh=mesh41, chunk_size=c))
            for c in (None, 4, 3)}
        doc["search"] = _result(plain)
        doc.update(_restore(mesh_lib, out, rank))
    with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
        json.dump(doc, f)
    dist.barrier()
    dist.destroy_process_group()


def _serve(mesh) -> dict:
    """The smoke qwen3-8b served in td mode plain and on ``mesh``: tokens
    and every step's logits, bit for bit."""
    import repro_torch.configs as cfgs
    from repro_torch.launch import serve, td_cli
    arch = td_cli.apply_td_args(cfgs.get_smoke("qwen3-8b"), "td")
    plain, meshed = {"logits": []}, {"logits": []}
    ids = serve.run(arch, 4, 16, 6, device="cpu", stats=plain)
    ids_m = serve.run(arch, 4, 16, 6, device="cpu", stats=meshed, mesh=mesh)
    return {"tokens_equal": bool(torch.equal(ids, ids_m)),
            "logits_equal": all(torch.equal(a, b) for a, b in
                                zip(plain["logits"], meshed["logits"])),
            "steps": len(meshed["logits"])}


def _scan_serve(mesh_lib) -> dict:
    """The stacked smoke qwen3-8b (quant, float32) served on a (2, 2)
    mesh: tokens equal to the unsharded serve's and logits within 1e-5
    of their scale (the tensor-parallel partial sums add in another
    order); its logits equal the unrolled layout's on the same mesh."""
    import dataclasses
    import repro_torch.configs as cfgs
    from repro_torch.configs.base import TrainCfg
    from repro_torch.launch import serve, td_cli
    from repro_torch.models import transformer
    loop = td_cli.apply_td_args(cfgs.get_smoke("qwen3-8b"), "quant").replace(
        train=TrainCfg(compute_dtype="float32"))
    scan = loop.replace(model=dataclasses.replace(loop.model,
                                                  scan_layers=True))
    mesh = mesh_lib.make_mesh((2, 2), ("data", "model"), device="cpu")
    runs = {}
    for name, arch, m in (("plain", scan, None), ("mesh", scan, mesh),
                          ("loop", loop, mesh)):
        runs[name] = {"logits": []}
        runs[name]["ids"] = serve.run(arch, 4, 8, 4, device="cpu",
                                      stats=runs[name], mesh=m)
    want = torch.stack(runs["plain"]["logits"])
    got = torch.stack(runs["mesh"]["logits"])
    err = float((got - want).abs().max())
    return {"stacked": transformer._can_scan(scan.model, None),
            "serve_close": err <= 1e-5 * float(want.abs().max()),
            "serve_max_err": err,
            "tokens_equal": bool(torch.equal(runs["plain"]["ids"],
                                             runs["mesh"]["ids"])),
            "layouts_equal": bool(torch.equal(
                got, torch.stack(runs["loop"]["logits"])))}


def _smoke(scan: bool = False):
    import dataclasses
    import repro_torch.configs as cfgs
    from repro_torch.models import get_api
    from repro_torch.tdsim import policy as td_policy
    cfg = dataclasses.replace(cfgs.get_smoke("granite-8b").model,
                              scan_layers=scan)
    params = get_api(cfg)["init"](0, cfg, td_policy.PRECISE, device="cpu")
    return cfg, params


def _forward(mesh_lib) -> dict:
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.launch import sharding
    from repro_torch.models import transformer
    from repro_torch.tdsim import policy as td_policy
    cfg, params = _smoke()
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab, (4, 16)).astype(np.int32))
    want = transformer.forward(params, {"tokens": toks}, cfg,
                               td_policy.PRECISE)[0]
    mesh = mesh_lib.make_mesh((2, 2), ("data", "model"), device="cpu")
    placed = sharding.distribute(
        params, sharding.param_specs(params, mesh), mesh)
    d_toks = distribute_tensor(toks, mesh, sharding.placements(
        sharding.batch_spec(mesh, 4, 2), mesh), src_data_rank=None)
    with sharding.sharded_region(mesh):
        got = transformer.forward(placed, {"tokens": d_toks}, cfg,
                                  td_policy.PRECISE)[0]
    full = got.full_tensor()
    sharded = sum(any(p.is_shard() for p in t.placements)
                  for t in _leaves(placed))
    # rtol 1e-5 of the logits' scale: the tensor-parallel partial sums
    # add in another order
    err = float((full - want).abs().max())
    return {"forward_close": err <= 1e-5 * float(want.abs().max()),
            "forward_max_err": err,
            "forward_scale": float(want.abs().max()),
            "forward_placements": [str(p) for p in got.placements],
            "sharded_leaves": int(sharded)}


def _embed_grad(mesh_lib) -> dict:
    """Gradients of a loss over `common.embed` and an lm_head, sharded on
    a (2, 2) mesh against unsharded (f32): the largest difference of each
    and its scale."""
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.launch import sharding
    from repro_torch.models import common
    rng = np.random.default_rng(5)
    params = {"embed": {"table": rng.standard_normal((128, 64))},
              "lm_head": {"w": rng.standard_normal((64, 128))}}
    params = {k: {n: torch.from_numpy(t.astype(np.float32))
                  for n, t in v.items()} for k, v in params.items()}
    toks = torch.from_numpy(rng.integers(0, 128, (4, 4096)).astype(np.int32))

    def grads(tree, ids):
        leaves = [tree["embed"]["table"], tree["lm_head"]["w"]]
        for t in leaves:
            t.requires_grad_(True)
        h = common.embed(tree["embed"], ids)
        ((h * h).sum(-1, keepdim=True) * (h @ tree["lm_head"]["w"])).mean(
        ).backward()
        return [t.grad for t in leaves]

    want = grads(params, toks)
    mesh = mesh_lib.make_mesh((2, 2), ("data", "model"), device="cpu")
    placed = sharding.distribute(
        {k: {n: t.detach() for n, t in v.items()} for k, v in params.items()},
        sharding.param_specs(params, mesh), mesh)
    ids = distribute_tensor(toks, mesh, sharding.placements(
        sharding.batch_spec(mesh, 4, 2), mesh), src_data_rank=None)
    with sharding.sharded_region(mesh):
        got = grads(placed, ids)
    return {"embed_grad": [[float((g.full_tensor() - w).abs().max()),
                            float(w.abs().max())]
                           for g, w in zip(got, want)]}


def _train(mesh_lib) -> dict:
    """One f32 train step of the smoke granite-8b at 4 x 512 tokens:
    `train_loss`, its backward and one AdamW update (the smoke config's
    own `TrainCfg`), with parameters placed by `param_specs` and the batch
    by `batch_spec` on a (2, 2) mesh, against the same step unsharded.
    For the loss, each gradient, each first moment and each updated
    parameter: the largest difference and the leaf's largest magnitude;
    and how many leaves the update moved."""
    from torch.distributed.tensor import distribute_tensor
    import repro_torch.configs as cfgs
    from repro_torch.launch import sharding
    from repro_torch.models import get_api
    from repro_torch.optim import adamw
    from repro_torch.tdsim import policy as td_policy
    cfg, params = _smoke()
    ids = np.random.default_rng(7).integers(0, cfg.vocab, (4, 513))
    batch = {"tokens": torch.from_numpy(ids[:, :-1].astype(np.int32)),
             "labels": torch.from_numpy(ids[:, 1:].astype(np.int32))}
    loss_fn = get_api(cfg)["train_loss"]
    tcfg = cfgs.get_smoke("granite-8b").train

    def step(tree, b):
        leaves = [t for _, t in adamw.tree_leaves_with_path(tree)]
        for t in leaves:
            t.requires_grad_(True)
        loss, _ = loss_fn(tree, b, cfg, td_policy.PRECISE)
        loss.backward()
        grads = adamw.tree_map(lambda t: t.grad, tree)
        new = adamw.tree_map(lambda t: t.detach().clone(), tree)
        opt = adamw.init_opt_state(new)
        new, opt, _ = adamw.apply_updates(new, grads, opt, tcfg)
        return loss.detach(), grads, opt.mu, new

    want = step(adamw.tree_map(lambda t: t.clone(), params), batch)
    mesh = mesh_lib.make_mesh((2, 2), ("data", "model"), device="cpu")
    placed = sharding.distribute(
        params, sharding.param_specs(params, mesh), mesh)
    d_batch = {k: distribute_tensor(v, mesh, sharding.placements(
        sharding.batch_spec(mesh, 4, 2), mesh), src_data_rank=None)
        for k, v in batch.items()}
    with sharding.sharded_region(mesh):
        got = step(placed, d_batch)

    def errs(a, b):
        return [[float((x.full_tensor() - y).abs().max()),
                 float(y.abs().max())] for (_, x), (_, y) in
                zip(_paths(a), _paths(b))]
    return {"train_loss": [float((got[0].full_tensor() - want[0]).abs()),
                           float(want[0].abs())],
            "train_grads": errs(got[1], want[1]),
            "train_mu": errs(got[2], want[2]),
            "train_params": errs(got[3], want[3]),
            "train_moved": sum(not torch.equal(x, y) for (_, x), (_, y) in
                               zip(_paths(want[3]), _paths(params))),
            "train_leaves": len(_paths(params))}


def _leaves(tree):
    from repro_torch.optim import adamw
    return [t for _, t in adamw.tree_leaves_with_path(tree)]


def _restore(mesh_lib, out: str, rank: int, scan: bool = False) -> dict:
    from repro_torch.checkpoint import ckpt
    from repro_torch.launch import sharding
    cfg, params = _smoke(scan)
    mesh = mesh_lib.make_mesh((2, 2), ("data", "model"), device="cpu")
    path = os.path.join(out, "ckpt")
    if rank == 0:
        ckpt.save(path, 3, params, async_write=False)
    dist.barrier()
    specs = sharding.param_specs(params, mesh)
    step, tree, _ = ckpt.restore(path, params, shardings=specs, mesh=mesh)
    flat_specs = {}
    sharding.map_with_path(lambda p, s: flat_specs.__setitem__(p, s), specs)
    equal, placed = [], []
    for (p, t), (_, want) in zip(
            _paths(tree), _paths(params)):
        equal.append(bool(torch.equal(t.full_tensor(), want)))
        placed.append(list(t.placements)
                      == sharding.placements(flat_specs[p], mesh))
    # placements given as tuples of Placement objects
    pl_tree = sharding.map_with_path(
        lambda p, s: tuple(sharding.placements(s, mesh)), specs)
    _, tree2, _ = ckpt.restore(path, params, shardings=pl_tree, mesh=mesh)
    equal2 = all(torch.equal(a.to_local(), b.to_local())
                 for (_, a), (_, b) in zip(_paths(tree2), _paths(tree)))
    return {"restore_step": step, "restore_equal": all(equal),
            "restore_placed": all(placed), "restore_by_placements": equal2,
            "restore_leaves": len(equal)}


def _paths(tree):
    from repro_torch.optim import adamw
    return adamw.tree_leaves_with_path(tree)


def main() -> None:
    out, world = sys.argv[1], int(sys.argv[2])
    mode = sys.argv[3] if len(sys.argv) > 3 else ""
    if world == 1:
        run(0, 1, out, mode)
    else:
        mp.start_processes(run, args=(world, out, mode), nprocs=world,
                           start_method="spawn")


if __name__ == "__main__":
    main()
