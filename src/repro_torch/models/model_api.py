"""Model API of the decoder family (port of the decoder entries of
`repro/models/model_api.py`):

  init(seed, cfg, pol)                          -> params
  train_loss(params, batch, cfg, pol, key, remat) -> (loss, metrics)
  prefill(params, batch, cfg, pol, s_cache)     -> (last_logits, state)
  decode_step(params, tok, state, cfg, pol)     -> (logits, state)

`state` is {"layers": [...per-layer cache...], "enc_out": None}.  With
``true_len`` the prefill serves a right-padded bucket and returns the
logits at each row's true last position; a decode step on per-row caches
(the serving engine's ragged slots) puts each row's query at its own fill
index.  `matmul_shapes` is the energy meter's ledger of every matmul a
token runs.  The enc-dec family comes later.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelCfg
from repro_torch.models import common, transformer
from repro_torch.tdsim.energy_meter import MatmulShape


def _dec_init(seed: int, cfg: ModelCfg, pol, dtype=torch.float32,
              device=None):
    return transformer.init_params(seed, cfg, pol, dtype, device)


def _dec_train_loss(params, batch, cfg: ModelCfg, pol, key=None,
                    remat: str = "none"):
    logits, _, aux = transformer.forward(params, batch, cfg, pol, key=key,
                                         remat=remat)
    loss = common.cross_entropy(logits, batch["labels"], batch.get("mask"))
    metrics = {"ce": loss}
    for k, v in aux.items():
        # the MoE's router losses join the loss; its dropped share is only
        # reported
        if k.startswith("moe_") and k != "moe_dropped":
            loss = loss + v
        metrics[k] = v
    metrics["loss"] = loss
    return loss, metrics


def _dec_prefill(params, batch, cfg: ModelCfg, pol, s_cache: int,
                 cache_dtype=torch.bfloat16, true_len=None):
    b = batch["tokens"].shape[0]
    dev = batch["tokens"].device
    caches = transformer.init_caches(b, s_cache, cfg, cache_dtype, dev)
    # lm_head runs over every padded row, as in the reference: td_vmm's
    # noise is hashed over the (M, N) the call is given
    logits, caches, _ = transformer.forward(params, batch, cfg, pol,
                                            caches=caches)
    if true_len is not None:
        # bucket-padded prompts (serving engine): causal masking keeps every
        # row < true_len clean of the pad junk, so the next-token logits
        # live at the true last prompt position (a host int), not the
        # padded one
        return (logits[:, true_len - 1:true_len],
                {"layers": caches, "enc_out": None})
    return logits[:, -1:], {"layers": caches, "enc_out": None}


def _dec_decode(params, tok, state, cfg: ModelCfg, pol):
    caches = state["layers"]
    idx = caches[0]["idx"]
    if isinstance(idx, torch.Tensor):
        # per-slot ragged caches: one query position per row
        pos = idx[:, None]
    else:
        pos = torch.full((1,), idx, dtype=torch.int32, device=tok.device)
    logits, new_caches, _ = transformer.forward(
        params, {"tokens": tok}, cfg, pol, caches=caches, positions=pos)
    return logits[:, -1], {"layers": new_caches, "enc_out": None}


# ---------------------------------------------------------------------------
# energy-meter ledger: every matmul per token, layer counts folded in
# ---------------------------------------------------------------------------
def matmul_shapes(cfg: ModelCfg) -> list[MatmulShape]:
    """The matmuls one token runs through an attention decoder (attention
    projections, the SwiGLU MLP or the MoE's top_k experts and router,
    lm_head), each with its layer count, as the reference's ledger lists
    them."""
    if cfg.family != "decoder" or cfg.rwkv is not None or \
            cfg.ssm is not None or \
            any(cfg.mixer_at(i) != "attn" for i in range(cfg.n_layers)):
        raise NotImplementedError(
            f"matmul_shapes of {cfg.name!r}: only attention decoders, dense "
            "and MoE, are ported (ROADMAP.md §1, step 13)")
    d, hd = cfg.d_model, cfg.hd
    hq, hkv, n = cfg.n_heads, cfg.n_kv_heads, cfg.n_layers
    out = [MatmulShape("attn.q", d, hq * hd, n),
           MatmulShape("attn.k", d, hkv * hd, n),
           MatmulShape("attn.v", d, hkv * hd, n),
           MatmulShape("attn.o", hq * hd, d, n)]
    if cfg.moe is not None:
        f, act = cfg.moe.d_ff_expert, cfg.moe.top_k
        out += [MatmulShape("moe.wi", d, f, n * act),
                MatmulShape("moe.wg", d, f, n * act),
                MatmulShape("moe.wo", f, d, n * act),
                MatmulShape("moe.router", d, cfg.moe.num_experts, n)]
    else:
        out += [MatmulShape("mlp.wi", d, cfg.d_ff, n),
                MatmulShape("mlp.wg", d, cfg.d_ff, n),
                MatmulShape("mlp.wo", cfg.d_ff, d, n)]
    return out + [MatmulShape("lm_head", d, cfg.vocab, 1.0)]


_API = {
    "decoder": dict(init=_dec_init, train_loss=_dec_train_loss,
                    prefill=_dec_prefill, decode_step=_dec_decode),
}


def get_api(cfg: ModelCfg) -> dict:
    if cfg.family not in _API:
        raise NotImplementedError(f"model family {cfg.family!r} is not yet "
                                  "ported (ROADMAP.md §1, step 13)")
    return _API[cfg.family]
