"""Shared harness of the train-step parity tests (`test_torch_train_*.py`):
one train step builder from each package on the same converted parameters
and the same numpy batches, and the parameter comparison with AdamW's sign
flips stated.  Not a test module itself."""
import numpy as np
import torch

import jax
import jax.numpy as jnp
import repro.configs as jcfgs
from repro.configs.base import ShapeCfg as JShape
from repro.configs.base import TDExecCfg as JTD
from repro.configs.base import TrainCfg as JTrain
from repro.kernels.td_vmm import ref as jtd_ref
from repro.launch import steps as jsteps
from repro.models import common as jcommon
from repro.models import get_api as jget_api
from repro.optim import adamw as jadamw
from repro.tdsim import td_linear as jlin
import repro_torch.configs as tcfgs
from repro_torch.configs.base import ShapeCfg as TShape
from repro_torch.configs.base import TDExecCfg as TTD
from repro_torch.configs.base import TrainCfg as TTrain
from repro_torch.convert import params_from_jax
from repro_torch.data.synthetic import DataCfg, SyntheticStream
from repro_torch.launch import steps as tsteps
from repro_torch.optim import adamw as tadamw

BATCH, SEQ = 4, 16


def archs(name: str, mode: str, dtype: str, n_micro: int = 2,
          remat: str = "full", n_layers: int | None = None,
          grad_dtype: str = "float32"):
    """(reference arch, port arch): the smoke config of ``name`` with
    ``--td mode`` and the given train settings (``grad_dtype``: the
    microbatch gradient sum's, ``grad_allreduce_dtype``)."""
    pair = []
    for cfgs, td, train in ((jcfgs, JTD, JTrain), (tcfgs, TTD, TTrain)):
        a = cfgs.get_smoke(name)
        if n_layers is not None:
            a = a.replace(model=a.model.__class__(**{
                **a.model.__dict__, "n_layers": n_layers}))
        pair.append(a.replace(
            td=td(mode=mode, n_chain=min(576, a.model.d_model)),
            train=train(n_microbatches=n_micro, remat=remat,
                        compute_dtype=dtype,
                        grad_allreduce_dtype=grad_dtype)))
    return tuple(pair)


def init_pair(ja):
    """The reference's init and its conversion to the port."""
    cfg = ja.model
    jp = jget_api(cfg)["init"](jax.random.key(0), cfg,
                               jcommon.resolve_arch_policy(ja))
    return jp, params_from_jax(jax.device_get(jp), cfg, device="cpu")


def _oracle_td_vmm(x_int, w_int, pol, seed):
    """The reference's td_vmm engine through its plain oracle
    `td_vmm_signed_ref` (the Pallas kernel's interpret mode cannot run
    under `jax.disable_jit`)."""
    k, n = w_int.shape
    lead = x_int.shape[:-1]
    out = jtd_ref.td_vmm_signed_ref(
        x_int.reshape(-1, k), w_int, bits_a=pol.bits_a, bits_w=pol.bits_w,
        n_chain=pol.n_chain, sigma=pol.sigma_chain, tdc_q=pol.tdc_q,
        seed=seed)
    return out.reshape(*lead, n)


def run_both(ja, ta, steps: int, jit: bool, monkeypatch):
    """``steps`` train steps in each package from the same parameters and
    batches.  Returns (reference losses, port losses, reference grad norms,
    port grad norms, reference lrs, reference params, port params)."""
    jp, tp = init_pair(ja)
    jo, to = jadamw.init_opt_state(jp), tadamw.init_opt_state(tp)
    jstep = jsteps.build_train_step(ja, JShape("t", SEQ, BATCH, "train"))
    tstep = tsteps.build_train_step(ta, TShape("t", SEQ, BATCH, "train"),
                                    device="cpu")
    if jit:
        jstep = jax.jit(jstep)
    else:
        monkeypatch.setattr(jlin.td_ops, "td_vmm_seeded", _oracle_td_vmm)
    stream = SyntheticStream(DataCfg(vocab=ja.model.vocab, seq_len=SEQ,
                                     global_batch=BATCH, seed=0))
    out = {k: [] for k in ("jl", "tl", "jg", "tg", "lr")}
    for i in range(steps):
        hb = stream.batch(i)
        jb = {k: jnp.asarray(v) for k, v in hb.items()}
        if jit:
            jp, jo, jm = jstep(jp, jo, jb, jnp.uint32(i))
        else:
            with jax.disable_jit():
                jp, jo, jm = jstep(jp, jo, jb, jnp.uint32(i))
        tp, to, tm = tstep(tp, to, {k: torch.from_numpy(v)
                                    for k, v in hb.items()}, i)
        out["jl"].append(float(jm["loss"]))
        out["tl"].append(float(tm["loss"]))
        out["jg"].append(float(jm["grad_norm"]))
        out["tg"].append(float(tm["grad_norm"]))
        out["lr"].append(float(jm["lr"]))
    return out, jax.device_get(jp), tp


def assert_params_close(jp, tp, lrs, atol: float, max_flip_share: float):
    """Every parameter within ``atol`` + 1e-6 relative, except a share of
    at most ``max_flip_share`` of all entries that may differ by up to
    AdamW's sign flip: an early Adam step moves a parameter by about lr
    whichever the gradient's size, so a gradient within rounding of 0 that
    changes sign moves it by up to 2 lr per step (bounded here by
    2.5 * sum(lr))."""
    flip = 2.5 * sum(lrs)
    n_all = n_far = 0
    jl = jax.tree_util.tree_leaves_with_path(jp)
    tl = tadamw.tree_leaves_with_path(tp)
    assert len(jl) == len(tl)
    for (_, a), (path, b) in zip(jl, tl):
        a = np.asarray(a, np.float32)
        b = b.float().numpy()
        assert a.shape == b.shape, path
        d = np.abs(a - b)
        far = d > atol + 1e-6 * np.abs(a)
        assert d.max() <= flip + atol, (path, d.max(), flip)
        n_all += d.size
        n_far += int(far.sum())
    assert n_far <= max_flip_share * n_all, (n_far, n_all)


def check_float32_steps(ja, ta, monkeypatch):
    """Two jitted reference steps against two port steps in float32 with
    the tolerances of `tests/test_torch_train_step.py`: losses rtol 1e-6,
    gradient norms rtol 1e-5, parameters within 1e-7 + 1e-6 relative with
    at most 0.1% of entries allowed AdamW's sign flip."""
    out, jp, tp = run_both(ja, ta, 2, jit=True, monkeypatch=monkeypatch)
    assert np.all(np.isfinite(out["tl"]))
    np.testing.assert_allclose(out["tl"], out["jl"], rtol=1e-6)
    np.testing.assert_allclose(out["tg"], out["jg"], rtol=1e-5)
    assert_params_close(jp, tp, out["lr"], atol=1e-7, max_flip_share=1e-3)
