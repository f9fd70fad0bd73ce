"""Serve steps (port of the serving half of `repro/launch/steps.py`):
prefill_step and serve_step (one greedy decode step).

Each step casts the parameters to the compute dtype, as the reference's
steps do.  `cast_tree` returns a leaf that already has that dtype as is,
so parameters stored in the compute dtype (`serve.run` stores them in
bf16 at init) are cast once, at load, instead of on every step.  The train
step waits for the optimizer port; the ragged-prefill, insert and adaptive
steps wait for the scheduler.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig, ShapeCfg
from repro_torch.models import common, get_api

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}


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
