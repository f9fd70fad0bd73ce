"""Step builders (port of `repro/launch/steps.py`): train_step
(microbatched gradient accumulation + AdamW), prefill_step and serve_step
(one greedy decode step).

Each step casts the parameters to the compute dtype, as the reference's
steps do.  `cast_tree` returns a leaf that already has that dtype as is,
so parameters stored in the compute dtype (`serve.run` stores them in
bf16 at init) are cast once, at load, instead of on every step.  The
ragged-prefill, insert and adaptive steps wait for the scheduler.
"""
from __future__ import annotations

import torch
from torch.profiler import record_function

from repro_torch import prng
from repro_torch.configs.base import ArchConfig, ShapeCfg
from repro_torch.models import common, get_api
from repro_torch.optim import adamw

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}


def build_train_step(arch: ArchConfig, shape: ShapeCfg):
    """``train_step(params, opt_state, batch, seed) -> (params, opt_state,
    metrics)``.

    The global batch splits into ``arch.microbatches_for(shape.name)``
    microbatches along dim 0; microbatch i runs under key
    ``fold_in(key(seed), i)`` (the key itself when there is one).
    Gradients with respect to the stored float32 parameters accumulate in
    their ``.grad`` (the reference sums them in ``grad_allreduce_dtype``,
    float32 in every config; the compressed bf16 sum is not ported) and are
    divided by the count, then `adamw.apply_updates` updates ``params`` and
    ``opt_state`` in place.
    Metrics are the microbatch means of loss and ce, and grad_norm and lr,
    all device tensors: the step itself never waits for the device."""
    cfg = arch.model
    pol = common.resolve_arch_policy(arch)
    api = get_api(cfg)
    n_micro = arch.microbatches_for(shape.name)
    compute_dt = DTYPES[arch.train.compute_dtype]
    if DTYPES[arch.train.grad_allreduce_dtype] != torch.float32:
        raise NotImplementedError("grad_allreduce_dtype other than float32 "
                                  "is not yet ported to repro_torch")

    def loss_fn(params, mb, key):
        p_c = common.cast_tree(params, compute_dt)
        return api["train_loss"](p_c, mb, cfg, pol, key,
                                 remat=arch.train.remat)

    def train_step(params, opt_state, batch, seed: int):
        key = prng.key(seed)
        leaves = [p for _, p in adamw.tree_leaves_with_path(params)]
        for p in leaves:
            p.requires_grad_(True)
            p.grad = None
        if n_micro == 1:
            mbs, keys = [batch], [key]
        else:
            mbs = [{k: v.reshape(n_micro, -1, *v.shape[1:])[i]
                    for k, v in batch.items()} for i in range(n_micro)]
            keys = [prng.fold_in(key, i) for i in range(n_micro)]
        mets = []
        for mb, k in zip(mbs, keys):
            loss, metrics = loss_fn(params, mb, k)
            loss.backward()
            mets.append({n: m.detach() for n, m in metrics.items()})
        by_id = {}
        for p in leaves:
            by_id[id(p)] = p.grad.div_(n_micro) if n_micro > 1 else p.grad
            p.grad = None
            p.requires_grad_(False)
        grads = adamw.tree_map(lambda p: by_id[id(p)], params)
        del by_id
        metrics = {n: torch.stack([m[n] for m in mets]).mean()
                   for n in mets[0]}
        with record_function("train.optimizer"):
            params, opt_state, om = adamw.apply_updates(params, grads,
                                                        opt_state, arch.train)
        return params, opt_state, {**metrics, **om}

    return train_step


def build_prefill_step(arch: ArchConfig, shape: ShapeCfg):
    cfg = arch.model
    pol = common.resolve_arch_policy(arch)
    api = get_api(cfg)
    compute_dt = DTYPES[arch.train.compute_dtype]

    def prefill_step(params, batch):
        p_c = common.cast_tree(params, compute_dt)
        b = {k: v for k, v in batch.items() if k != "labels"}
        return api["prefill"](p_c, b, cfg, pol, s_cache=shape.seq_len)

    return prefill_step


def build_serve_step(arch: ArchConfig, shape: ShapeCfg):
    """One decode step: new token against a seq_len KV cache."""
    cfg = arch.model
    pol = common.resolve_arch_policy(arch)
    api = get_api(cfg)
    compute_dt = DTYPES[arch.train.compute_dtype]

    def serve_step(params, tok, state):
        p_c = common.cast_tree(params, compute_dt)
        logits, new_state = api["decode_step"](p_c, tok, state, cfg, pol)
        next_tok = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
        return next_tok, new_state

    return serve_step
