"""Model API of the decoder family (port of the decoder entries of
`repro/models/model_api.py`):

  init(seed, cfg, pol)                          -> params
  train_loss(params, batch, cfg, pol, key, remat) -> (loss, metrics)
  prefill(params, batch, cfg, pol, s_cache)     -> (last_logits, state)
  decode_step(params, tok, state, cfg, pol)     -> (logits, state)

`state` is {"layers": [...per-layer cache...], "enc_out": None}.  The
enc-dec family and the energy-meter ledger come later.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelCfg
from repro_torch.models import common, transformer


def _dec_init(seed: int, cfg: ModelCfg, pol, dtype=torch.float32,
              device=None):
    return transformer.init_params(seed, cfg, pol, dtype, device)


def _dec_train_loss(params, batch, cfg: ModelCfg, pol, key=None,
                    remat: str = "none"):
    logits, _, _ = transformer.forward(params, batch, cfg, pol, key=key,
                                       remat=remat)
    loss = common.cross_entropy(logits, batch["labels"], batch.get("mask"))
    return loss, {"ce": loss, "loss": loss}


def _dec_prefill(params, batch, cfg: ModelCfg, pol, s_cache: int,
                 cache_dtype=torch.bfloat16):
    b = batch["tokens"].shape[0]
    dev = batch["tokens"].device
    caches = transformer.init_caches(b, s_cache, cfg, cache_dtype, dev)
    logits, caches, _ = transformer.forward(params, batch, cfg, pol,
                                            caches=caches)
    return logits[:, -1:], {"layers": caches, "enc_out": None}


def _dec_decode(params, tok, state, cfg: ModelCfg, pol):
    caches = state["layers"]
    pos = torch.full((1,), caches[0]["idx"], dtype=torch.int32,
                     device=tok.device)
    logits, new_caches, _ = transformer.forward(
        params, {"tokens": tok}, cfg, pol, caches=caches, positions=pos)
    return logits[:, -1], {"layers": new_caches, "enc_out": None}


_API = {
    "decoder": dict(init=_dec_init, train_loss=_dec_train_loss,
                    prefill=_dec_prefill, decode_step=_dec_decode),
}


def get_api(cfg: ModelCfg) -> dict:
    if cfg.family not in _API:
        raise NotImplementedError(f"model family {cfg.family!r} is not yet "
                                  "ported (ROADMAP.md §1, step 13)")
    return _API[cfg.family]
