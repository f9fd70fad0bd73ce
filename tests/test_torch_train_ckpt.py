"""Port parity of checkpointing (`repro_torch.checkpoint.ckpt`) and the
checkpointed, fault-scheduled training driver (`repro_torch.launch.train`)
against the reference (`repro.checkpoint.ckpt`, `repro.launch.train`).

* The manifest's leaf names, shapes, dtypes and sha256 digests equal the
  reference's `_flatten` and `_digest` for the same float32 parameter tree
  (the reference's init of the smoke granite-8b, converted), and for the
  (params, optimizer state) pair the train driver saves; a bfloat16 leaf
  keeps the reference's bytes and digest.
* Restore falls back past a corrupted newest step, for each corruption
  mode; ``.tmp`` litter is invisible; a named step never falls back; an
  all-corrupt directory raises.
* Async save failures surface on `wait()` and on the next save into the
  same directory.
* Training: the chaos recipe (12 steps, a save every 4, a stall at 2, a
  bitflip of the newest checkpoint at 9, a preemption at 10) resumes at 4,
  with losses equal to its own fault-free run bit for bit on the CPU, as
  the reference's chaos bench requires of the reference; the CLI's
  ``--ckpt-dir`` resumes from the newest step.
"""
import torch_threads  # noqa: F401  (first: torch's threads under xdist)
import json
import os
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import repro.configs as jcfgs
from repro.checkpoint import ckpt as jckpt
from repro.models import common as jcommon
from repro.models import get_api as jget_api
from repro.optim import adamw as jadamw
import repro_torch.configs as tcfgs
from repro_torch import ft
from repro_torch.checkpoint import ckpt
from repro_torch.configs.base import ShapeCfg, TDExecCfg
from repro_torch.convert import params_from_jax
from repro_torch.launch import train as ttrain
from repro_torch.optim import adamw as tadamw


def _tree(step: int) -> dict:
    return {"w": np.full((8, 8), float(step), np.float32),
            "b": np.arange(4, dtype=np.float32) + step}


def _publish(d: str, steps=(1, 2)) -> None:
    for s in steps:
        ckpt.save(d, s, _tree(s), async_write=False)


def _manifest(d: str, step: int) -> dict:
    with open(os.path.join(d, f"step_{step:08d}", ckpt.MANIFEST)) as f:
        return json.load(f)


def test_manifest_matches_reference_flatten_and_digest(tmp_path):
    ja = jcfgs.get_smoke("granite-8b")
    cfg = ja.model
    jp = jget_api(cfg)["init"](jax.random.key(0), cfg,
                               jcommon.resolve_arch_policy(ja))
    tp = params_from_jax(jax.device_get(jp), cfg, device="cpu")
    for step, (jtree, ttree) in enumerate([
            (jp, tp),
            ((jp, jadamw.init_opt_state(jp)),
             (tp, tadamw.init_opt_state(tp)))], start=1):
        ckpt.save(str(tmp_path), step, ttree, async_write=False)
        m = _manifest(str(tmp_path), step)
        names, vals, _ = jckpt._flatten(jtree)
        host = [np.asarray(v) for v in vals]
        assert m["names"] == names
        assert m["shapes"] == [list(v.shape) for v in host]
        assert m["dtypes"] == [str(v.dtype) for v in host]
        assert m["digests"] == [jckpt._digest(v) for v in host]
        got, tree, _ = ckpt.restore(str(tmp_path), ttree, step=step)
        assert got == step
        for (n, a), (_, b) in zip(tadamw.tree_leaves_with_path(
                tree if step == 1 else tree[0]),
                tadamw.tree_leaves_with_path(tp)):
            assert torch.equal(a, b), n
    # a bfloat16 leaf: the reference's bytes, dtype name and digest
    x = np.random.default_rng(0).normal(size=(3, 5)).astype(np.float32)
    jb = np.asarray(jnp.asarray(x, jnp.bfloat16))
    tb = torch.from_numpy(x).to(torch.bfloat16)
    ckpt.save(str(tmp_path), 9, {"b": tb, "s": torch.tensor(3)},
              async_write=False)
    m = _manifest(str(tmp_path), 9)
    assert m["dtypes"] == ["bfloat16", "int64"]
    assert m["digests"][0] == jckpt._digest(jb)
    _, back, _ = ckpt.restore(str(tmp_path), {"b": tb, "s": None}, step=9)
    assert back["b"].dtype == torch.bfloat16 and torch.equal(back["b"], tb)


@pytest.mark.parametrize("mode", ["bitflip", "truncate", "rm_manifest"])
def test_corrupt_newest_falls_back(tmp_path, mode):
    d = str(tmp_path)
    _publish(d)
    assert ft.corrupt_checkpoint(d, mode, seed=5) == 2
    with pytest.raises(ckpt.CorruptCheckpoint):
        ckpt.verify(d, 2)
    step, tree, _ = ckpt.restore(d, _tree(0))
    assert step == 1
    np.testing.assert_array_equal(tree["w"].numpy(), _tree(1)["w"])


def test_tmp_litter_invisible_and_intact_restore(tmp_path):
    d = str(tmp_path)
    _publish(d)
    assert ft.corrupt_checkpoint(d, "tmp_litter") is None
    assert ckpt.latest_steps(d) == [1, 2]
    step, tree, meta = ckpt.restore(d, _tree(0))
    assert step == 2 and meta == {}
    np.testing.assert_array_equal(tree["b"].numpy(), _tree(2)["b"])
    ckpt.verify(d, 1)
    with pytest.raises(FileNotFoundError):
        ckpt.restore(str(tmp_path / "none"), _tree(0))
    with pytest.raises(ValueError, match="missing keys"):
        ckpt.restore(d, {"w": None, "x": None})


def test_explicit_step_never_falls_back_and_all_corrupt_raises(tmp_path):
    d = str(tmp_path)
    _publish(d)
    ft.corrupt_checkpoint(d, "bitflip", step=2, seed=7)
    with pytest.raises(ckpt.CorruptCheckpoint):
        ckpt.restore(d, _tree(0), step=2)
    assert ckpt.restore(d, _tree(0))[0] == 1
    ft.corrupt_checkpoint(d, "truncate", step=1)
    with pytest.raises(ckpt.CorruptCheckpoint, match="no intact"):
        ckpt.restore(d, _tree(0))


def _broken_savez(monkeypatch):
    def boom(*a, **kw):
        raise OSError(28, "No space left on device")
    monkeypatch.setattr(ckpt.np, "savez", boom)


def test_async_save_errors_surface_on_wait_and_next_save(tmp_path,
                                                         monkeypatch):
    _broken_savez(monkeypatch)
    h = ckpt.save(str(tmp_path / "a"), 1, _tree(1))
    with pytest.raises(RuntimeError, match="step 1 failed") as ei:
        h.wait()
    assert isinstance(ei.value.__cause__, OSError)
    h.wait()                        # observed exactly once
    d = str(tmp_path / "b")
    h = ckpt.save(d, 1, _tree(1))   # nobody calls wait()
    while not h.done():
        time.sleep(0.005)
    monkeypatch.undo()              # the disk recovers
    with pytest.raises(RuntimeError, match="step 1 failed"):
        ckpt.save(d, 2, _tree(2))
    h = ckpt.save(d, 3, _tree(3))
    h.wait()
    assert ckpt.latest_steps(d) == [3] and h.write_s is not None


def test_save_copies_before_the_writer_and_keeps_last(tmp_path):
    d = str(tmp_path)
    t = {"w": torch.zeros(4)}
    for s in range(1, 6):
        h = ckpt.save(d, s, t, keep_last=2)
        t["w"].add_(1.0)            # an in-place update, as AdamW's
        h.wait()
    assert ckpt.latest_steps(d) == [4, 5]
    assert torch.equal(ckpt.restore(d, t)[1]["w"], torch.full((4,), 4.0))


def _chaos_run(ckpt_dir, schedule, record):
    arch = tcfgs.get_smoke("granite-8b").replace(td=TDExecCfg(mode="quant"))
    shape = ShapeCfg("chaos", 32, 2, "train")

    def session():
        return ttrain.run(arch, shape, 12, ckpt_dir, ckpt_every=4,
                          log_every=10 ** 9, schedule=schedule,
                          record=record, device="cpu")

    return ft.run_with_retries(session, policy=ft.RetryPolicy(backoff_s=0.0),
                               on_restart=lambda n, e: None)[1]


def test_train_chaos_resumes_at_last_intact_step(tmp_path):
    oracle = _chaos_run(None, None, {})
    sched = ft.FaultSchedule([
        ft.FaultEvent(2, "stall", {"duration_s": 0.01}),
        ft.FaultEvent(9, "ckpt_corrupt", {"mode": "bitflip", "seed": 3}),
        ft.FaultEvent(10, "preempt")])
    rec = {}
    losses = _chaos_run(str(tmp_path), sched, rec)
    assert rec["starts"] == [0, 4]
    assert {k for _, k in rec["faults"]} == {"stall", "ckpt_corrupt",
                                             "preempt"}
    assert np.array_equal(losses, oracle[4:])
    assert ckpt.latest_steps(str(tmp_path)) == [4, 8, 12]
    for s in (4, 8, 12):
        ckpt.verify(str(tmp_path), s)


def test_train_cli_ckpt_dir_resumes(tmp_path, capsys):
    d = str(tmp_path)
    arch = tcfgs.get_smoke("granite-8b").replace(td=TDExecCfg(mode="quant"))
    _, first = ttrain.run(arch, ShapeCfg("cli", 16, 2, "train"), 2, d,
                          ckpt_every=1, device="cpu")
    assert ckpt.latest_steps(d) == [1, 2] and len(first) == 2
    losses = ttrain.main(["--smoke", "--td", "quant", "--device", "cpu",
                          "--ckpt-dir", d, "--steps", "3", "--seq", "16",
                          "--batch", "2"])
    assert len(losses) == 1 and np.all(np.isfinite(losses))
    assert "[train] resumed from step 2" in capsys.readouterr().out
