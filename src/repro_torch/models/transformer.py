"""Decoder-only stack for the attention family, dense and MoE (port of
`repro/models/transformer.py`), with the layer loop unrolled.

Layer anatomy (pre-norm residual):
    x += attn(ln1(x))
    x += ffn(ln2(x))        ffn in {swiglu, moe}

Stub frontends (a VLM's vision tower, as the reference's): ``embeds``,
precomputed patch embeddings (B, Nv, d_frontend), go through the
``adapter`` dense (at the top-level policy) and are prepended to the
token embeddings.  With ``tie_embeddings`` there is no lm_head: the
logits are ``x @ embed.table.T``, a plain matmul as in the reference.
The other mixers (mamba2, rwkv6, shared attention), the RWKV channel mix
and per-layer FFN patterns come with their families.  `forward` returns
the layers' aux losses (the MoE's), summed in layer order.

Keys: layer i's mixer denses draw their noise seeds under
``fold_key(key, 2i)``, its FFN under ``fold_key(key, 2i + 1)``, lm_head
under ``fold_key(key, 10_000)``, as in the reference.  `_walk` (the
layers) and `_head` hold that order for `forward` and `forward_lanes`.

`forward_lanes` runs P probes of the batched noise search (the LM
per-layer sweep of `benchmarks/bench_noise_tolerance._lm_eval_fns`) in one
pass: the lanes fold into the batch, lane major, and every td dense is one
td_vmm launch over the P lanes with the shared weight; attention runs on
flash_attn over the folded batch.  The two differ only in the ``dense``
callback they hand `_walk`.
"""
from __future__ import annotations

import torch
import torch.utils.checkpoint
from torch.utils.checkpoint import (CheckpointPolicy,
                                    create_selective_checkpoint_contexts)

from repro_torch import device as device_mod
from repro_torch.configs.base import ModelCfg
from repro_torch.kernels.td_vmm import ref as td_ref
from repro_torch.models import attention, common, ffn
from repro_torch.tdsim import td_linear


def _check_supported(cfg: ModelCfg) -> None:
    if cfg.family == "encdec":
        raise ValueError(f"{cfg.name}: an enc-dec model runs through "
                         "models.encdec (model_api's 'encdec' entry), not "
                         "the decoder stack")
    unported = []
    if cfg.family != "decoder":
        unported.append(f"family {cfg.family!r}")
    if any(cfg.mixer_at(i) != "attn" for i in range(cfg.n_layers)):
        unported.append("non-attention mixers")
    if cfg.rwkv is not None or cfg.ffn_pattern:
        unported.append("FFNs other than SwiGLU and MoE")
    if unported:
        raise NotImplementedError(f"{cfg.name}: {', '.join(unported)} not "
                                  "yet ported (ROADMAP.md §1, step 13)")


def _ffn_kind(cfg: ModelCfg) -> str:
    return "moe" if cfg.moe is not None else "swiglu"


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
    if cfg.frontend is not None:
        params["adapter"] = common.dense_init(
            gen, cfg.d_frontend or cfg.d_model, cfg.d_model, top,
            dtype=dtype, device=dev)
    layers = []
    for i in range(cfg.n_layers):
        pol_i = common.pol_at(pol, i)
        lp = {"ln1": common.rmsnorm_init(cfg.d_model, dtype, dev),
              "ln2": common.rmsnorm_init(cfg.d_model, dtype, dev),
              "attn": attention.attn_init(gen, cfg, pol_i, dtype, dev)}
        if _ffn_kind(cfg) == "moe":
            lp["moe"] = ffn.moe_init(gen, cfg.d_model, cfg.moe, pol_i, dtype,
                                     dev)
        else:
            lp["mlp"] = ffn.swiglu_init(gen, cfg.d_model, cfg.d_ff, pol_i,
                                        dtype, dev)
        layers.append(lp)
    params["layers"] = layers
    params["final_norm"] = common.rmsnorm_init(cfg.d_model, dtype, dev)
    if not cfg.tie_embeddings:
        params["lm_head"] = common.dense_init(
            gen, cfg.d_model, cfg.vocab, top, dtype=dtype,
            scale=1.0 / cfg.d_model ** 0.5, device=dev)
    return params


# a layer's denses by key path (2i + part, j): the mixer's wq, wk, wv, wo
# (part 0), the SwiGLU FFN's wg, wi, wo (part 1)
_DENSES = ((0, 4), (1, 3))


def _layer_apply(lp: dict, x: torch.Tensor, cfg: ModelCfg, dense, i: int,
                 positions: torch.Tensor, cache: dict | None, key,
                 attn_pols=None, pol=None
                 ) -> tuple[torch.Tensor, dict | None, dict]:
    def mix(p, h, j):
        return dense(i, (2 * i, j), p, h)

    def mlp(p, h, j):
        return dense(i, (2 * i + 1, j), p, h)

    h = common.rmsnorm(lp["ln1"], x, cfg.rms_eps)
    y, new_cache = attention.attention(lp["attn"], h, cfg, None, positions,
                                       cache=cache,
                                       key=common.fold_key(key, 2 * i),
                                       attn_pols=attn_pols, dense=mix)
    x = x + y
    h = common.rmsnorm(lp["ln2"], x, cfg.rms_eps)
    if "moe" in lp:
        y, aux = ffn.moe_ffn(lp["moe"], h, cfg.moe, common.pol_at(pol, i),
                             common.fold_key(key, 2 * i + 1))
        return x + y, new_cache, aux
    return x + ffn.swiglu(lp["mlp"], h, None, dense=mlp), new_cache, {}


# the matmuls without batch dims, in any dtype
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    """The reference's ``checkpoint_dots_with_no_batch_dims``: keep the
    results of matmuls without batch dims, recompute everything else
    (the batched expert products, attention, and every kernel launch,
    which no dispatch sees)."""
    if op in _DOTS:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _dots_contexts():
    return create_selective_checkpoint_contexts(_dots_policy)


def _walk(params: dict, x: torch.Tensor, cfg: ModelCfg, dense,
          positions: torch.Tensor, key=None, attn_pols=None,
          caches: list | None = None, remat: str = "none",
          layers: range | None = None, pol=None
          ) -> tuple[torch.Tensor, list, dict]:
    """The decoder's layers in order (``layers``: a range of them, all by
    default), shared by `forward` and `forward_lanes`.  ``dense(i, fold,
    p, h)`` computes a dense of layer i with params p on h; ``fold`` is
    the dense's key path from the forward's key, ``(2i, j)`` for the
    mixer's j-th dense and ``(2i + 1, j)`` for the FFN's.  ``key`` seeds
    TD attention (``fold_key(key, 2i, 4)``) and the MoE's experts, which
    run at ``pol_at(pol, i)`` (`ffn.moe_ffn`).  ``remat``: "full"
    recomputes each layer in the backward from its input, "dots" keeps
    its unbatched matmuls' results and recomputes the rest.  Returns (x,
    the layers' new caches, None where a layer has no cache, the layers'
    aux losses summed in layer order)."""
    new_caches: list = [None] * cfg.n_layers
    aux_all: dict = {}
    for i in (range(cfg.n_layers) if layers is None else layers):
        cache = caches[i] if caches is not None else None
        args = (params["layers"][i], x, cfg, dense, i, positions, cache, key,
                attn_pols, pol)
        if remat == "none":
            x, new_caches[i], aux = _layer_apply(*args)
        else:
            x, new_caches[i], aux = torch.utils.checkpoint.checkpoint(
                _layer_apply, *args, use_reentrant=False,
                preserve_rng_state=False,
                **({"context_fn": _dots_contexts} if remat == "dots"
                   else {}))
        for name, v in aux.items():
            aux_all[name] = aux_all[name] + v if name in aux_all else v
    return x, new_caches, aux_all


def _policy_dense(pol, key):
    """`_walk`'s ``dense`` for one forward: layer i at ``pol_at(pol, i)``,
    its noise seeded by ``fold_key(key, *fold)``."""
    def dense(i, fold, p, h):
        return td_linear.linear(p, h, common.pol_at(pol, i),
                                common.fold_key(key, *fold))
    return dense


def _head(params: dict, x: torch.Tensor, cfg: ModelCfg, top, key
          ) -> torch.Tensor:
    """Final norm and lm_head (under ``fold_key(key, 10_000)``), or with
    tied embeddings the plain product with the embedding table."""
    x = common.rmsnorm(params["final_norm"], x, cfg.rms_eps)
    if cfg.tie_embeddings:
        return x @ params["embed"]["table"].T
    return common.dense(params["lm_head"], x, top,
                        common.fold_key(key, 10_000))


def _embed(params: dict, batch: dict, cfg: ModelCfg, pol) -> torch.Tensor:
    """The token embeddings, after the adapter's projection of a stub
    frontend's ``embeds`` when the batch has them (the adapter runs at the
    top-level policy with no key, as in the reference)."""
    x = common.embed(params["embed"], batch["tokens"])
    if cfg.frontend is not None and "embeds" in batch:
        emb = common.dense(params["adapter"], batch["embeds"],
                           common.pol_top(pol))
        x = torch.cat([emb.to(x.dtype), x], dim=1)
    return x


def forward(params: dict, batch: dict, cfg: ModelCfg, pol,
            caches: list | None = None,
            positions: torch.Tensor | None = None,
            key=None, remat: str = "none"
            ) -> tuple[torch.Tensor, list | None, dict]:
    """Returns (logits, new_caches, aux).  batch: {"tokens": (B, S)} and,
    for a stub frontend, {"embeds": (B, Nv, d_frontend)}: the logits then
    cover the Nv frontend positions first.

    ``remat="full"`` recomputes each layer in the backward
    (`torch.utils.checkpoint`, the reference's `jax.checkpoint`), keeping
    only the layer inputs; ``"dots"`` (the reference's
    ``checkpoint_dots_with_no_batch_dims``) keeps the results of the
    matmuls without batch dims (``aten.mm`` / ``addmm``: the precise and
    quant denses and the router) and recomputes the rest, td_vmm and the
    attention kernels included (`torch.utils.checkpoint`'s selective
    checkpointing).  The recomputed td matmuls draw the same noise as the
    first pass: the noise is a counter hash of the seed, with no generator
    state to restore."""
    _check_supported(cfg)
    if remat not in ("none", "full", "dots"):
        raise ValueError(f"remat={remat!r}: none, dots or full")
    x = _embed(params, batch, cfg, pol)
    if positions is None:
        positions = torch.arange(x.shape[1], device=x.device)
    x, new_caches, aux = _walk(params, x, cfg, _policy_dense(pol, key),
                               positions, key, common.pol_attn(pol), caches,
                               remat, pol=pol)
    logits = _head(params, x, cfg, common.pol_top(pol), key)
    return logits, (new_caches if caches is not None else None), aux


@torch.no_grad()
def forward_lanes(params: dict, batch: dict, cfg: ModelCfg, base_pol,
                  sigma: torch.Tensor, keys, top_pol) -> torch.Tensor:
    """P probes in one pass: ``batch`` {"tokens": (B, S)} shared, ``sigma``
    (P, n_layers) each probe's noise std per layer (on the tokens'
    device), ``keys`` P raw PRNG keys.  Layer i of lane p runs
    ``base_pol`` at ``sigma[p, i]``, lm_head runs ``top_pol``.  Returns
    (P, B, S, vocab) logits; lane p equals ``forward(params, batch, cfg,
    NetworkPolicy(layers=(base_pol.replace(sigma_chain=sigma[p, i]),
    ...), top=top_pol), key=keys[p])`` bit for bit.

    The layers before the first one where any lane's sigma is nonzero run
    once for all lanes (at sigma 0 the noise term is exactly zero); from
    there the lanes fold into the batch.  lm_head runs lane by lane, so
    each lane's matmul has the single pass's shape.  Reading the first
    noisy layer costs one copy of ``sigma`` to the host a call, and the
    lanes' seeds of every dense one copy to the device."""
    _check_supported(cfg)
    if _ffn_kind(cfg) != "swiglu":
        raise NotImplementedError(
            f"{cfg.name}: forward_lanes of an MoE decoder is not yet ported "
            "(ROADMAP.md §1, item 7)")
    p_lanes, n_layers = len(keys), cfg.n_layers
    if tuple(sigma.shape) != (p_lanes, n_layers):
        raise ValueError(f"sigma {tuple(sigma.shape)} for {p_lanes} keys "
                         f"and {n_layers} layers")
    noisy = (sigma != 0).any(0).tolist()
    first = noisy.index(True) if any(noisy) else n_layers
    x = common.embed(params["embed"], batch["tokens"])
    b, s, d = x.shape
    dev = x.device
    positions = torch.arange(s, device=dev)
    x, _, _ = _walk(params, x, cfg,
                    _policy_dense(base_pol.replace(sigma_chain=0.0), None),
                    positions, layers=range(first))
    # the seeds of every lane dense, a column each
    folds = [(2 * i + part, j) for i in range(first, n_layers)
             for part, n_dense in _DENSES for j in range(n_dense)]
    col = {f: c for c, f in enumerate(folds)}
    seeds = torch.tensor([[td_ref.derive_seed(common.fold_key(k, *f))
                           for f in folds] for k in keys],
                         dtype=torch.int64, device=dev)
    tdc_q = torch.full((p_lanes,), float(base_pol.tdc_q),
                       dtype=torch.float32, device=dev)
    sigma = sigma.to(torch.float32)

    def lane_dense(i, fold, p, h):
        y = td_linear.linear_lanes(p, h.reshape(p_lanes, -1, h.shape[-1]),
                                   base_pol, sigma[:, i], tdc_q,
                                   seeds[:, col[fold]])
        return y.reshape(*h.shape[:-1], y.shape[-1])

    x = x.expand(p_lanes, b, s, d).reshape(p_lanes * b, s, d)
    x, _, _ = _walk(params, x, cfg, lane_dense, positions,
                    layers=range(first, n_layers))
    x = x.reshape(p_lanes, b, s, d)
    return torch.stack([_head(params, x[p], cfg, top_pol, keys[p])
                        for p in range(p_lanes)])


def init_caches(b: int, s_cache: int, cfg: ModelCfg, dtype=torch.bfloat16,
                device=None, per_row_idx: bool = False) -> list:
    """One KV cache per layer; ``per_row_idx`` builds the serving engine's
    ragged-slot caches (one fill index per batch row)."""
    _check_supported(cfg)
    dev = device_mod.resolve(device)
    return [attention.init_cache(b, s_cache, cfg, dtype, dev, per_row_idx)
            for _ in range(cfg.n_layers)]
