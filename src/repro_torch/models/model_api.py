"""Model API over the two families, decoder-only and enc-dec (port of
`repro/models/model_api.py`):

  init(seed, cfg, pol)                          -> params
  train_loss(params, batch, cfg, pol, key, remat) -> (loss, metrics)
  prefill(params, batch, cfg, pol, s_cache)     -> (last_logits, state)
  decode_step(params, tok, state, cfg, pol)     -> (logits, state)

`state` is {"layers": [...per-layer cache...] or one stacked cache tree
(`transformer.init_caches(pol=)`), "enc_out": None or the encoder's output
(B, S_src, d)}.  A batch holds "tokens" and, for a stub
frontend or an enc-dec model, "embeds" (the precomputed patch or frame
embeddings); a decoder's train loss skips the logits of the frontend
positions.  With ``true_len`` the decoder prefill serves a right-padded
bucket and returns the logits at each row's true last position; a decode
step on per-row caches (the serving engine's ragged slots) puts each
row's query at its own fill index; a decode step takes its position from
the first KV cache, or none for a pure-SSM model.  `matmul_shapes` is the
energy meter's ledger of every matmul a token runs.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelCfg
from repro_torch.models import common, encdec, transformer
from repro_torch.tdsim.energy_meter import MatmulShape


def _dec_init(seed: int, cfg: ModelCfg, pol, dtype=torch.float32,
              device=None):
    return transformer.init_params(seed, cfg, pol, dtype, device)


def _dec_train_loss(params, batch, cfg: ModelCfg, pol, key=None,
                    remat: str = "none"):
    logits, _, aux = transformer.forward(params, batch, cfg, pol, key=key,
                                         remat=remat)
    if cfg.frontend is not None and "embeds" in batch:
        logits = logits[:, batch["embeds"].shape[1]:]
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
    caches = transformer.init_caches(b, s_cache, cfg, cache_dtype, dev,
                                     pol=pol)
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
    # the position is the fill index of the first KV cache (all equal
    # across layers; a per-row (B,) vector for ragged serving slots), or
    # the one index of stacked caches; a pure-SSM model has none, and no
    # RoPE to read it
    if isinstance(caches, dict):
        idx = caches.get("idx")
    else:
        idx = next((c["idx"] for c in caches if "idx" in c), None)
    if idx is None:
        pos = torch.zeros((1,), dtype=torch.int32, device=tok.device)
    elif isinstance(idx, torch.Tensor):
        pos = idx[:, None]
    else:
        pos = torch.full((1,), idx, dtype=torch.int32, device=tok.device)
    logits, new_caches, _ = transformer.forward(
        params, {"tokens": tok}, cfg, pol, caches=caches, positions=pos)
    return logits[:, -1], {"layers": new_caches, "enc_out": None}


# ---------------------------------------------------------------------------
# enc-dec family
# ---------------------------------------------------------------------------
def _ed_init(seed: int, cfg: ModelCfg, pol, dtype=torch.float32,
             device=None):
    return encdec.init_params(seed, cfg, pol, dtype, device)


def _ed_train_loss(params, batch, cfg: ModelCfg, pol, key=None,
                   remat: str = "none"):
    enc_out = encdec.encode(params, batch["embeds"], cfg, pol, key=key,
                            remat=remat)
    logits, _ = encdec.decode(params, batch["tokens"], enc_out, cfg, pol,
                              key=key, remat=remat)
    loss = common.cross_entropy(logits, batch["labels"], batch.get("mask"))
    return loss, {"ce": loss, "loss": loss}


def _ed_prefill(params, batch, cfg: ModelCfg, pol, s_cache: int,
                cache_dtype=torch.bfloat16):
    enc_out = encdec.encode(params, batch["embeds"], cfg, pol)
    b = batch["tokens"].shape[0]
    caches = encdec.init_caches(b, s_cache, cfg, cache_dtype,
                                batch["tokens"].device)
    logits, caches = encdec.decode(params, batch["tokens"], enc_out, cfg,
                                   pol, caches=caches)
    return logits[:, -1:], {"layers": caches, "enc_out": enc_out}


def _ed_decode(params, tok, state, cfg: ModelCfg, pol):
    caches = state["layers"]
    pos = torch.full((1,), caches[0]["self"]["idx"], dtype=torch.int32,
                     device=tok.device)
    logits, new_caches = encdec.decode(params, tok, state["enc_out"], cfg,
                                       pol, caches=caches, positions=pos)
    return logits[:, -1], {"layers": new_caches,
                           "enc_out": state["enc_out"]}


# ---------------------------------------------------------------------------
# energy-meter ledger: every matmul per token, layer counts folded in
# ---------------------------------------------------------------------------
def matmul_shapes(cfg: ModelCfg) -> list[MatmulShape]:
    """The matmuls one token runs, each with its layer count, as the
    reference's ledger lists them: attention projections at the attention
    and shared-attention sites, mamba2's in and out projections, rwkv6's
    five time-mix denses, then the FFN (the RWKV channel mix, the MoE's
    top_k experts and router, or the SwiGLU MLP), an enc-dec model's
    encoder and cross-attention, and lm_head.  Its quirks are kept: the
    FFN entries count every layer (zamba2's ``mlp.*`` at all 38 layers,
    though only its 6 shared sites have a SwiGLU), the enc-dec entries
    count each encoder attention projection and cross-attention
    projection at (d, Hq * Dh) and the encoder's three MLP matmuls at (d,
    d_ff); the adapter is not in the ledger, and lm_head is counted with
    tied embeddings too."""
    d, hd = cfg.d_model, cfg.hd
    hq, hkv, n = cfg.n_heads, cfg.n_kv_heads, cfg.n_layers
    mixers = [cfg.mixer_at(i) for i in range(n)]
    n_attn = sum(m in ("attn", "shared_attn") for m in mixers)
    n_mamba = mixers.count("mamba2")
    n_rwkv = mixers.count("rwkv6")
    out = []
    if n_attn:
        out += [MatmulShape("attn.q", d, hq * hd, n_attn),
                MatmulShape("attn.k", d, hkv * hd, n_attn),
                MatmulShape("attn.v", d, hkv * hd, n_attn),
                MatmulShape("attn.o", hq * hd, d, n_attn)]
    if n_mamba and cfg.ssm:
        di = cfg.ssm.expand * d
        nh = di // cfg.ssm.head_dim
        out += [MatmulShape("mamba.in", d,
                            2 * di + 2 * cfg.ssm.d_state + nh, n_mamba),
                MatmulShape("mamba.out", di, d, n_mamba)]
    if n_rwkv:
        out += [MatmulShape(f"rwkv.{nm}", d, d, n_rwkv)
                for nm in ("r", "k", "v", "g", "o")]
    if cfg.rwkv is not None:
        out += [MatmulShape("cm.k", d, cfg.d_ff, n),
                MatmulShape("cm.v", cfg.d_ff, d, n),
                MatmulShape("cm.r", d, d, n)]
    elif cfg.moe is not None:
        f, act = cfg.moe.d_ff_expert, cfg.moe.top_k
        out += [MatmulShape("moe.wi", d, f, n * act),
                MatmulShape("moe.wg", d, f, n * act),
                MatmulShape("moe.wo", f, d, n * act),
                MatmulShape("moe.router", d, cfg.moe.num_experts, n)]
    else:
        out += [MatmulShape("mlp.wi", d, cfg.d_ff, n),
                MatmulShape("mlp.wg", d, cfg.d_ff, n),
                MatmulShape("mlp.wo", cfg.d_ff, d, n)]
    if cfg.family == "encdec":
        n_enc = cfg.n_enc_layers or n
        out += [MatmulShape("enc.attn", d, hq * hd, 4 * n_enc),
                MatmulShape("enc.mlp", d, cfg.d_ff, 3 * n_enc),
                MatmulShape("dec.xattn", d, hq * hd, 4 * n)]
    return out + [MatmulShape("lm_head", d, cfg.vocab, 1.0)]


_API = {
    "decoder": dict(init=_dec_init, train_loss=_dec_train_loss,
                    prefill=_dec_prefill, decode_step=_dec_decode),
    "encdec": dict(init=_ed_init, train_loss=_ed_train_loss,
                   prefill=_ed_prefill, decode_step=_ed_decode),
}


def get_api(cfg: ModelCfg) -> dict:
    if cfg.family not in _API:
        raise NotImplementedError(f"model family {cfg.family!r} is not in "
                                  f"the registry ({', '.join(_API)})")
    return _API[cfg.family]
