"""Encoder-decoder stack, the seamless-m4t family (port of
`repro/models/encdec.py`): a bidirectional encoder over stub audio-frame
embeddings and a causal decoder with cross-attention on the encoder's
output.

    encode(params, embeds)           (B, S_src, d_frontend) -> (B, S_src, d)
    decode(params, tokens, enc_out)  -> (logits, new caches)

The frontend is a stub, as in the reference: ``embeds`` are precomputed
frame embeddings, projected by the ``adapter`` dense.  Decode caches are
one self-attention KV cache a decoder layer (``{"self": cache}``); the
cross-attention K and V are recomputed from ``enc_out`` at every call, as
the reference's `decode` does.

Keys: encoder layer i's attention draws its noise under ``fold_key(key,
2i)`` and its FFN under ``fold_key(key, 2i + 1)``; decoder layer i's
self-attention under ``fold_key(key, 3i)``, its cross-attention under
``3i + 1`` and its FFN under ``3i + 2``; lm_head under ``fold_key(key,
10_000)``; the adapter under no key.  One policy runs every dense (the
reference resolves per-layer and TD-attention policies for decoders
only).  ``remat`` "full" and "dots" both recompute each layer in the
backward from its input: the reference checkpoints an enc-dec layer
without a saving policy under either name.
"""
from __future__ import annotations

import torch
import torch.utils.checkpoint

from repro_torch import device as device_mod
from repro_torch.configs.base import ModelCfg
from repro_torch.models import attention, common, ffn


def init_params(seed: int, cfg: ModelCfg, pol, dtype=torch.float32,
                device=None) -> dict:
    """Seeded random parameters with the reference's distributions and
    tree (``adapter``, ``embed``, ``enc_norm``, ``final_norm``,
    ``lm_head``, ``encoder[i]`` and ``decoder[i]``); each tensor drawn in
    float32 on ``device`` and stored in ``dtype``."""
    dev = device_mod.resolve(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    n_enc = cfg.n_enc_layers or cfg.n_layers
    d = cfg.d_model

    def norm():
        return common.rmsnorm_init(d, dtype, dev)

    params: dict = {
        "adapter": common.dense_init(gen, cfg.d_frontend or d, d, pol,
                                     dtype=dtype, device=dev),
        "embed": common.embed_init(gen, cfg.vocab, d, dtype, dev),
        "enc_norm": norm(),
        "final_norm": norm(),
        "lm_head": common.dense_init(gen, d, cfg.vocab, pol, dtype=dtype,
                                     scale=1.0 / d ** 0.5, device=dev),
    }
    params["encoder"] = [
        {"ln1": norm(), "ln2": norm(),
         "attn": attention.attn_init(gen, cfg, pol, dtype, dev),
         "mlp": ffn.swiglu_init(gen, d, cfg.d_ff, pol, dtype, dev)}
        for _ in range(n_enc)]
    params["decoder"] = [
        {"ln1": norm(), "ln_x": norm(), "ln2": norm(),
         "attn": attention.attn_init(gen, cfg, pol, dtype, dev),
         "xattn": attention.attn_init(gen, cfg, pol, dtype, dev,
                                      cross=True),
         "mlp": ffn.swiglu_init(gen, d, cfg.d_ff, pol, dtype, dev)}
        for _ in range(cfg.n_layers)]
    return params


def _run(layer, remat: str, *args):
    """``layer(*args)``, recomputed in the backward under remat."""
    if remat == "none":
        return layer(*args)
    if remat not in ("full", "dots"):
        raise ValueError(f"remat={remat!r}: none, dots or full")
    return torch.utils.checkpoint.checkpoint(
        layer, *args, use_reentrant=False, preserve_rng_state=False)


def encode(params: dict, embeds: torch.Tensor, cfg: ModelCfg, pol,
           key=None, remat: str = "none") -> torch.Tensor:
    """embeds (B, S_src, d_frontend) stub frame embeddings -> the encoder's
    normed output (B, S_src, d_model); self-attention over all frames
    (causal when ``cfg.enc_bidirectional`` is off), RoPE at
    ``arange(S_src)``."""
    x = common.dense(params["adapter"], embeds, pol)
    positions = torch.arange(x.shape[1], device=x.device)

    def layer(lp, xx, i):
        h = common.rmsnorm(lp["ln1"], xx, cfg.rms_eps)
        y, _ = attention.attention(lp["attn"], h, cfg, pol, positions,
                                   causal=not cfg.enc_bidirectional,
                                   key=common.fold_key(key, 2 * i))
        xx = xx + y
        h = common.rmsnorm(lp["ln2"], xx, cfg.rms_eps)
        return xx + ffn.swiglu(lp["mlp"], h, pol,
                               common.fold_key(key, 2 * i + 1))

    for i, lp in enumerate(params["encoder"]):
        x = _run(layer, remat, lp, x, i)
    return common.rmsnorm(params["enc_norm"], x, cfg.rms_eps)


def decode(params: dict, tokens: torch.Tensor, enc_out: torch.Tensor,
           cfg: ModelCfg, pol, caches: list | None = None,
           positions: torch.Tensor | None = None, key=None,
           remat: str = "none") -> tuple[torch.Tensor, list | None]:
    """tokens (B, S) against ``enc_out`` (B, S_src, d) -> (logits (B, S,
    vocab), the layers' new caches, or None without ``caches``).  Each
    layer: causal self-attention (with its cache), cross-attention on
    ``enc_out``, SwiGLU, each pre-normed."""
    x = common.embed(params["embed"], tokens)
    if positions is None:
        positions = torch.arange(x.shape[1], device=x.device)

    def layer(lp, xx, cache, i):
        h = common.rmsnorm(lp["ln1"], xx, cfg.rms_eps)
        y, nc = attention.attention(lp["attn"], h, cfg, pol, positions,
                                    cache=cache,
                                    key=common.fold_key(key, 3 * i))
        xx = xx + y
        h = common.rmsnorm(lp["ln_x"], xx, cfg.rms_eps)
        y, _ = attention.attention(lp["xattn"], h, cfg, pol, positions,
                                   kv_from=enc_out, causal=False,
                                   key=common.fold_key(key, 3 * i + 1))
        xx = xx + y
        h = common.rmsnorm(lp["ln2"], xx, cfg.rms_eps)
        xx = xx + ffn.swiglu(lp["mlp"], h, pol,
                             common.fold_key(key, 3 * i + 2))
        return xx, nc

    new_caches: list = [None] * cfg.n_layers
    for i, lp in enumerate(params["decoder"]):
        cache = caches[i]["self"] if caches is not None else None
        x, nc = _run(layer, remat, lp, x, cache, i)
        if nc is not None:
            new_caches[i] = {"self": nc}
    x = common.rmsnorm(params["final_norm"], x, cfg.rms_eps)
    logits = common.dense(params["lm_head"], x, pol,
                          common.fold_key(key, 10_000))
    return logits, (new_caches if caches is not None else None)


def init_caches(b: int, s_cache: int, cfg: ModelCfg, dtype=torch.bfloat16,
                device=None) -> list:
    """One self-attention KV cache a decoder layer."""
    dev = device_mod.resolve(device)
    return [{"self": attention.init_cache(b, s_cache, cfg, dtype, dev)}
            for _ in range(cfg.n_layers)]
