"""Step builders (port of `repro/launch/steps.py`): train_step
(microbatched gradient accumulation + AdamW), prefill_step and serve_step
(one greedy decode step), the continuous-batching engine's
ragged-prefill and insert steps, and the forward-only loss eval.

Each step casts the parameters to the compute dtype, as the reference's
steps do; a batch's frontend ``embeds`` and an enc-dec state's
``enc_out`` pass through as they come (the reference casts neither: a
float32 frame batch meets the bf16 weights in float32, the matmuls'
promotion).  `cast_tree` returns a leaf that already has that dtype as
is, so parameters stored in the compute dtype (`serve.run` stores them
in bf16 at init) are cast once, at load, instead of on every step.
`build_adaptive_serve_step` is the drift-adaptive decode step of the
continuous-batching engine.
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


def build_train_step(arch: ArchConfig, shape: ShapeCfg, device=None):
    """``train_step(params, opt_state, batch, seed) -> (params, opt_state,
    metrics)``.  ``device`` is where the TD policy solve runs (None = CUDA,
    as in every builder here); the step runs where its tensors lie.

    The global batch splits into ``arch.microbatches_for(shape.name)``
    microbatches along dim 0; microbatch i runs under key
    ``fold_in(key(seed), i)`` (the key itself when there is one).
    Gradients with respect to the stored float32 parameters are summed over
    the microbatches in ``grad_allreduce_dtype``: in float32 they
    accumulate in their ``.grad``; in bfloat16 (the compressed sum) each
    microbatch's float32 gradient is cast to bf16 and added, in microbatch
    order, into a bf16 sum that starts at zero, as the reference's scan
    does.  The sum is divided by the count in its dtype (a single
    microbatch's gradient stays float32, as in the reference), then
    `adamw.apply_updates` updates ``params`` and ``opt_state`` in place.
    Metrics are the microbatch means of loss and ce, and grad_norm and lr,
    all device tensors: the step itself never waits for the device."""
    cfg = arch.model
    pol = common.resolve_arch_policy(arch, device=device)
    api = get_api(cfg)
    n_micro = arch.microbatches_for(shape.name)
    compute_dt = DTYPES[arch.train.compute_dtype]
    ar_dt = DTYPES[arch.train.grad_allreduce_dtype]
    # float32 sums accumulate in .grad; others in sums of their own
    own_sum = n_micro > 1 and ar_dt != torch.float32

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
        sums = [torch.zeros(p.shape, dtype=ar_dt, device=p.device)
                for p in leaves] if own_sum else None
        for mb, k in zip(mbs, keys):
            loss, metrics = loss_fn(params, mb, k)
            loss.backward()
            mets.append({n: m.detach() for n, m in metrics.items()})
            if own_sum:
                for p, acc in zip(leaves, sums):
                    if p.grad is not None:
                        acc.add_(p.grad.to(ar_dt))
                    p.grad = None
        by_id = {}
        for j, p in enumerate(leaves):
            if own_sum:
                by_id[id(p)] = sums[j].div_(torch.full(
                    (), n_micro, dtype=ar_dt, device=p.device))
            elif p.grad is None:
                # a leaf the loss never reads (a mixer-only layer's ln2):
                # jax.grad's zeros
                by_id[id(p)] = torch.zeros_like(p)
            else:
                by_id[id(p)] = (p.grad.div_(n_micro) if n_micro > 1
                                else p.grad)
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


def build_prefill_step(arch: ArchConfig, shape: ShapeCfg, device=None):
    cfg = arch.model
    pol = common.resolve_arch_policy(arch, device=device)
    api = get_api(cfg)
    compute_dt = DTYPES[arch.train.compute_dtype]

    def prefill_step(params, batch):
        p_c = common.cast_tree(params, compute_dt)
        b = {k: v for k, v in batch.items() if k != "labels"}
        return api["prefill"](p_c, b, cfg, pol, s_cache=shape.seq_len)

    return prefill_step


def build_serve_step(arch: ArchConfig, shape: ShapeCfg, device=None,
                     logits_out: list | None = None):
    """One decode step: new token against a seq_len KV cache.  Each
    step's logits are appended to ``logits_out`` when one is given."""
    cfg = arch.model
    pol = common.resolve_arch_policy(arch, device=device)
    api = get_api(cfg)
    compute_dt = DTYPES[arch.train.compute_dtype]

    def serve_step(params, tok, state):
        p_c = common.cast_tree(params, compute_dt)
        logits, new_state = api["decode_step"](p_c, tok, state, cfg, pol)
        if logits_out is not None:
            logits_out.append(logits)
        next_tok = common.argmax_last(logits).to(torch.int32)[:, None]
        return next_tok, new_state

    return serve_step


def build_adaptive_serve_step(arch: ArchConfig, shape: ShapeCfg,
                              device=None):
    """Drift-adaptive decode step (`repro/launch/steps.py:106-136`):
    `build_serve_step` plus (a) the policy's (sigma_chain, tdc_q) bound to
    the runtime operand tensor ``ops`` (`common.runtime_td_policy`: the
    engine swaps an operating point by writing into ``ops`` in place, and
    the step is built once) and (b) the activation bit density of this
    step's token embeddings (`ft.drift.measure_p_x_one`), masked by
    ``active``, the (B,) occupancy of the continuous batch: free slots
    carry a stale last token.  ``serve_step(params, tok, state, ops,
    active) -> (next_tok, new_state, p_x_one)``, p_x_one a 0-d f32 device
    tensor; nothing here waits for the device."""
    from repro_torch.ft import drift as ft_drift

    cfg = arch.model
    pol = common.resolve_arch_policy(arch, device=device)
    api = get_api(cfg)
    compute_dt = DTYPES[arch.train.compute_dtype]
    bits_a = common.pol_at(pol, 0).bits_a
    bound: list = [None, None]          # (ops, its runtime policy)

    def serve_step(params, tok, state, ops, active):
        if bound[0] is not ops:
            bound[:] = [ops, common.runtime_td_policy(pol, ops)]
        p_c = common.cast_tree(params, compute_dt)
        logits, new_state = api["decode_step"](p_c, tok, state, cfg,
                                               bound[1])
        next_tok = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
        px = ft_drift.measure_p_x_one(
            common.embed(params["embed"], tok[:, 0]).to(torch.float32),
            bits_a, mask=active)
        return next_tok, new_state, px

    return serve_step


def build_ragged_prefill_step(arch: ArchConfig, prompt_pad: int,
                              device=None):
    """Bucketed prefill of the continuous-batching serve engine.

    ``prefill_step(params, toks, true_len) -> (next_tok (B, 1), state)``:
    ``toks`` (B, prompt_pad) right-padded, ``true_len`` the true prompt
    length (a host int, the same for every row).  The causal mask keeps
    every row below the true length clean of the pad junk, and the
    next-token logits are read at the true last position.  The caches are sized
    at ``prompt_pad``; the insert step copies them into a decode slot."""
    cfg = arch.model
    if cfg.family != "decoder":
        raise ValueError("ragged prefill requires a decoder-family model, "
                         f"got {cfg.family!r}")
    pol = common.resolve_arch_policy(arch, device=device)
    api = get_api(cfg)
    compute_dt = DTYPES[arch.train.compute_dtype]

    def prefill_step(params, toks, true_len):
        p_c = common.cast_tree(params, compute_dt)
        logits, state = api["prefill"](p_c, {"tokens": toks}, cfg, pol,
                                       s_cache=prompt_pad, true_len=true_len)
        tok = torch.argmax(logits[:, -1], -1).to(torch.int32)[:, None]
        return tok, state

    return prefill_step


def build_insert_step():
    """Copy a b = 1 prefilled state into slot ``slot`` of the batched
    decode state (the slot-recycle primitive of the continuous-batching
    engine), in place, and return the batched state.

    Each layer's K/V rows are written at the slot, as a prefix when the
    prefill cache is shorter than the decode cache; the slot's fill index
    is set to ``length``, the true prompt length, which is what masks the
    pad junk the bucketed prefill wrote past it.  ``slot`` and ``length``
    are host ints: nothing here waits for the device."""

    def insert_step(dst_state, src_state, slot: int, length: int):
        for dst, src in zip(dst_state["layers"], src_state["layers"]):
            n = src["k"].shape[1]
            dst["k"][slot, :n] = src["k"][0]
            dst["v"][slot, :n] = src["v"][0]
            # fill_ passes the int as a kernel argument; item assignment
            # would copy it from the host
            dst["idx"][slot].fill_(length)
        return dst_state

    return insert_step


def build_forward_eval(arch: ArchConfig):
    """Forward-only loss eval (`repro/launch/steps.py:195-204`, the noise
    runs on LMs): ``eval_step(params, batch, pol, key) -> metrics``, the
    train loss's metrics of ``params`` as given (no cast) under the
    caller's policy, no gradient kept."""
    cfg = arch.model
    api = get_api(cfg)

    @torch.no_grad()
    def eval_step(params, batch, pol, key):
        _, metrics = api["train_loss"](params, batch, cfg, pol, key)
        return metrics

    return eval_step
