"""Shared harness of the entry-point parity tests of the stub-frontend and
enc-dec models (`test_torch_encdec_serve.py`, `test_torch_frontend.py`):
the port's `serve.run` and `train.run` on the reference's converted
parameters, against the reference's own steps and train driver on the
same numpy inputs, float32 compute, quant mode; and the float32
gradient comparison of their train-loss tests.  Not a test module
itself."""
import numpy as np
import torch

import jax
import jax.numpy as jnp
import repro.configs as jcfgs
from repro.configs.base import ShapeCfg as JShape
from repro.configs.base import TDExecCfg as JTD
from repro.configs.base import TrainCfg as JTrain
from repro.launch import steps as jsteps
from repro.launch import train as jtrain
from repro.models import common as jcommon
from repro.models import get_api as jget_api
import repro_torch.configs as tcfgs
from repro_torch.configs.base import ShapeCfg as TShape
from repro_torch.configs.base import TDExecCfg as TTD
from repro_torch.configs.base import TrainCfg as TTrain
from repro_torch.convert import params_from_jax
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as ttrain
from repro_torch.models import model_api as tmodel_api


def assert_grad_close(got: np.ndarray, want: np.ndarray, name: str):
    """A float32 gradient leaf against the reference's: within 1e-4 of
    the leaf's largest entry, a 0-d leaf (an LSQ step size, a sum over a
    whole layer whose terms cancel) within 1e-3 relative."""
    if want.ndim == 0:
        np.testing.assert_allclose(got, want, rtol=1e-3, err_msg=name)
    else:
        np.testing.assert_allclose(
            got, want, rtol=0, atol=1e-4 * float(np.abs(want).max()) + 1e-12,
            err_msg=name)


def archs(name: str, mode: str = "quant", n_micro: int = 1):
    """(reference arch, port arch): the smoke config of ``name`` in
    ``--td mode`` with float32 compute."""
    return tuple(cfgs.get_smoke(name).replace(
        td=td(mode=mode, n_chain=48),
        train=train(compute_dtype="float32", n_microbatches=n_micro))
        for cfgs, td, train in ((jcfgs, JTD, JTrain),
                                (tcfgs, TTD, TTrain)))


def use_reference_init(ja, monkeypatch):
    """The port's ``api["init"]`` for ``ja``'s family returns the
    reference's init at ``jax.random.key(seed)``, converted and stored in
    the requested dtype."""
    cfg = ja.model
    pol = jcommon.resolve_arch_policy(ja)

    def init(seed, tcfg, tpol, dtype=torch.float32, device=None):
        jp = jget_api(cfg)["init"](jax.random.key(seed), cfg, pol)
        tp = params_from_jax(jax.device_get(jp), tcfg, device=device)
        return tmodel_api.common.cast_tree(tp, dtype)

    monkeypatch.setitem(tmodel_api._API[cfg.family], "init", init)
    return pol


def serve_both(name: str, batch: int, prompt_len: int, gen: int,
               monkeypatch, seed: int = 0, pair: tuple | None = None):
    """The port's `serve.run` and the reference's prefill and serve steps
    on the same parameters, prompts and frontend embeddings (bf16, as
    `serve.run` feeds them; none without a frontend), the reference's
    caches sized as the port's: ``(port tokens, reference tokens,
    frontend positions)``.  ``pair`` (reference arch, port arch) replaces
    `archs` (name)'s quant-mode pair."""
    ja, ta = pair or archs(name)
    use_reference_init(ja, monkeypatch)
    cfg = ja.model
    ids = tserve.run(ta, batch, prompt_len, gen, seed=seed, device="cpu")
    n_front = (max(8, prompt_len // 2)
               if cfg.frontend is not None or cfg.family == "encdec" else 0)
    s_cache = prompt_len + gen + (n_front if cfg.family == "decoder" else 0)
    shape = JShape("serve", s_cache, batch, "decode")
    pre = jax.jit(jsteps.build_prefill_step(ja, shape))
    srv = jax.jit(jsteps.build_serve_step(ja, shape))
    jp = jget_api(cfg)["init"](jax.random.key(seed), cfg,
                               jcommon.resolve_arch_policy(ja))
    batch_in = {"tokens": jnp.asarray(tserve.prompts(seed, batch,
                                                     prompt_len, cfg.vocab))}
    if n_front:
        emb = tserve.frontend_embeds(seed, batch, n_front,
                                     cfg.d_frontend or cfg.d_model)
        batch_in["embeds"] = jnp.asarray(emb).astype(jnp.bfloat16)
    logits, state = pre(jp, batch_in)
    tok = jnp.argmax(logits[:, -1], -1).astype(jnp.int32)[:, None]
    out = [np.asarray(tok)]
    for _ in range(gen - 1):
        tok, state = srv(jp, tok, state)
        out.append(np.asarray(tok))
    return ids.numpy(), np.concatenate(out, 1), n_front


def train_both(name: str, steps: int, seq: int, batch: int, monkeypatch,
               n_micro: int = 1):
    """``steps`` steps of each package's `train.run` from the same
    parameters (the reference's init) on the same synthetic stream and
    frontend batches: (port losses, reference losses)."""
    ja, ta = archs(name, n_micro=n_micro)
    use_reference_init(ja, monkeypatch)
    _, tl = ttrain.run(ta, TShape("t", seq, batch, "train"), steps, None,
                       device="cpu")
    _, jl = jtrain.run(ja, JShape("t", seq, batch, "train"), steps, None)
    return tl, jl
