"""Decoder-only stack for the dense attention family (port of
`repro/models/transformer.py`), with the layer loop unrolled.

Layer anatomy (pre-norm residual):
    x += attn(ln1(x))
    x += swiglu(ln2(x))

The other mixers (mamba2, rwkv6, shared attention) and FFNs (MoE, RWKV
channel mix), stub frontends and tied embeddings come with their families.

Keys: layer i's mixer denses draw their noise seeds under
``fold_key(key, 2i)``, its FFN under ``fold_key(key, 2i + 1)``, lm_head
under ``fold_key(key, 10_000)``, as in the reference.
"""
from __future__ import annotations

import torch
import torch.utils.checkpoint

from repro_torch import device as device_mod
from repro_torch.configs.base import ModelCfg
from repro_torch.models import attention, common, ffn


def _check_supported(cfg: ModelCfg) -> None:
    unported = []
    if cfg.family != "decoder":
        unported.append(f"family {cfg.family!r}")
    if any(cfg.mixer_at(i) != "attn" for i in range(cfg.n_layers)):
        unported.append("non-attention mixers")
    if cfg.moe is not None or cfg.rwkv is not None or cfg.ffn_pattern:
        unported.append("non-SwiGLU FFNs")
    if cfg.frontend is not None:
        unported.append("stub frontends")
    if cfg.tie_embeddings:
        unported.append("tied embeddings")
    if unported:
        raise NotImplementedError(f"{cfg.name}: {', '.join(unported)} not "
                                  "yet ported (ROADMAP.md §1, step 13)")


def init_params(seed: int, cfg: ModelCfg, pol, dtype=torch.float32,
                device=None) -> dict:
    """Seeded random parameters with the reference's distributions.  Each
    tensor is drawn in float32 on ``device`` and stored in ``dtype``."""
    _check_supported(cfg)
    dev = device_mod.resolve(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    top = common.pol_top(pol)
    params: dict = {"embed": common.embed_init(gen, cfg.vocab, cfg.d_model,
                                               dtype, dev)}
    layers = []
    for i in range(cfg.n_layers):
        pol_i = common.pol_at(pol, i)
        layers.append({
            "ln1": common.rmsnorm_init(cfg.d_model, dtype, dev),
            "ln2": common.rmsnorm_init(cfg.d_model, dtype, dev),
            "attn": attention.attn_init(gen, cfg, pol_i, dtype, dev),
            "mlp": ffn.swiglu_init(gen, cfg.d_model, cfg.d_ff, pol_i, dtype,
                                   dev),
        })
    params["layers"] = layers
    params["final_norm"] = common.rmsnorm_init(cfg.d_model, dtype, dev)
    params["lm_head"] = common.dense_init(
        gen, cfg.d_model, cfg.vocab, top, dtype=dtype,
        scale=1.0 / cfg.d_model ** 0.5, device=dev)
    return params


def _layer_apply(lp: dict, x: torch.Tensor, cfg: ModelCfg, pol, i: int,
                 positions: torch.Tensor, cache: dict | None, key,
                 attn_pols=None) -> tuple[torch.Tensor, dict | None]:
    kmix = common.fold_key(key, 2 * i)
    kffn = common.fold_key(key, 2 * i + 1)
    h = common.rmsnorm(lp["ln1"], x, cfg.rms_eps)
    y, new_cache = attention.attention(lp["attn"], h, cfg, pol, positions,
                                       cache=cache, key=kmix,
                                       attn_pols=attn_pols)
    x = x + y
    h = common.rmsnorm(lp["ln2"], x, cfg.rms_eps)
    return x + ffn.swiglu(lp["mlp"], h, pol, kffn), new_cache


def forward(params: dict, batch: dict, cfg: ModelCfg, pol,
            caches: list | None = None,
            positions: torch.Tensor | None = None,
            key=None, remat: str = "none"
            ) -> tuple[torch.Tensor, list | None, dict]:
    """Returns (logits, new_caches, aux).  batch: {"tokens": (B, S)}.

    ``remat="full"`` recomputes each layer in the backward
    (`torch.utils.checkpoint`, the reference's `jax.checkpoint`), keeping
    only the layer inputs.  The recomputed td matmuls draw the same noise
    as the first pass: the noise is a counter hash of the seed, with no
    generator state to restore.  ``"dots"`` is not ported."""
    _check_supported(cfg)
    if remat not in ("none", "full"):
        raise NotImplementedError(f"remat={remat!r} is not yet ported to "
                                  "repro_torch (ported: none, full)")
    tokens = batch["tokens"]
    x = common.embed(params["embed"], tokens)
    s = x.shape[1]
    if positions is None:
        positions = torch.arange(s, device=x.device)
    attn_pols = common.pol_attn(pol)
    new_caches: list = [None] * cfg.n_layers
    for i, lp in enumerate(params["layers"]):
        cache = caches[i] if caches is not None else None
        args = (lp, x, cfg, common.pol_at(pol, i), i, positions, cache, key,
                attn_pols)
        if remat == "full":
            x, new_caches[i] = torch.utils.checkpoint.checkpoint(
                _layer_apply, *args, use_reentrant=False,
                preserve_rng_state=False)
        else:
            x, new_caches[i] = _layer_apply(*args)
    x = common.rmsnorm(params["final_norm"], x, cfg.rms_eps)
    logits = common.dense(params["lm_head"], x, common.pol_top(pol),
                          common.fold_key(key, 10_000))
    return logits, (new_caches if caches is not None else None), {}


def init_caches(b: int, s_cache: int, cfg: ModelCfg, dtype=torch.bfloat16,
                device=None, per_row_idx: bool = False) -> list:
    """One KV cache per layer; ``per_row_idx`` builds the serving engine's
    ragged-slot caches (one fill index per batch row)."""
    _check_supported(cfg)
    dev = device_mod.resolve(device)
    return [attention.init_cache(b, s_cache, cfg, dtype, dev, per_row_idx)
            for _ in range(cfg.n_layers)]
