"""The decoder-only stack (port of `repro/models/transformer.py`): the
dense, MoE, hybrid (zamba2) and attention-free (rwkv6) families through
per-layer mixer dispatch, in the unrolled or the stacked layout.

Layer anatomy (pre-norm residual):
    x += mixer(ln1(x))      mixer in {attn, shared_attn, mamba2, rwkv6}
    x += ffn(ln2(x))        ffn   in {swiglu, moe, rwkv_cm, none}

The mixer of layer i is ``cfg.mixer_at(i)``, its FFN `_ffn_kind(cfg, i)`
(``cfg.ffn_pattern`` when given; "none" is a mixer-only layer, whose
``ln2`` is never read).  "shared_attn" (zamba2) applies one weight-tied
attention block, ``params["shared_attn"]``, at several depths: it was
initialised under the top-level policy and runs under it at every site
(also under ``--td-per-layer``), each site with its own key and KV cache.
The RWKV channel mix's token shift ``shift_c`` rides in the layer's
time-mix state.

Stub frontends (a VLM's vision tower, as the reference's): ``embeds``,
precomputed patch embeddings (B, Nv, d_frontend), go through the
``adapter`` dense (at the top-level policy) and are prepended to the
token embeddings.  With ``tie_embeddings`` there is no lm_head: the
logits are ``x @ embed.table.T``, a plain matmul as in the reference.
`forward` returns the layers' aux losses (the MoE's), summed in layer
order.

Keys: layer i's mixer denses draw their noise seeds under
``fold_key(key, 2i)``, its FFN under ``fold_key(key, 2i + 1)``, lm_head
under ``fold_key(key, 10_000)``, as in the reference.  `_walk` (the
layers) and `_head` hold that order for `forward` and `forward_lanes`.

The stacked layout (``cfg.scan_layers``, the reference's scan over
layers): on a homogeneous stack (`_is_homogeneous`: one mixer kind, one
FFN kind, no shared-attention site) under a homogeneous policy
(`_can_scan`), ``params["layers"]`` is one dict of tensors with a
leading layer axis (L, ...), and the decode caches are one dict too
(K/V (L, B, S, Hkv, Dh), SSM states (L, B, ...)) whose fill index
``idx`` is one host int, or one (B,) tensor, for all layers: the
reference stacks it to (L,) or (L, B) of equal rows.  Layer i of such a
forward runs as the reference's scan body does: at ``pol_at(pol, 0)``,
its mixer denses seeded under ``fold_key(key, i, 0)``, its FFN under
``fold_key(key, i, 1)``, and its aux losses summed as one sum over the
stacked values.  The layers' weights are views, one ``torch.unbind`` a
leaf a forward, so that autograd stacks a weight's gradients once.

`forward_lanes` runs P probes of the batched noise search (the LM
per-layer sweep of `benchmarks/bench_noise_tolerance._lm_eval_fns`) in one
pass: the lanes fold into the batch, lane major, and every td dense is one
td_vmm launch over the P lanes with the shared weight; attention runs on
flash_attn over the folded batch.  The two differ only in the ``dense``
(and ``moe``) callbacks they hand `_walk`.  It runs every decoder family:
the MoE routes each lane apart and runs its P x E expert products as
lanes of one launch, the scans start each folded row at zero, and the
shared block runs at the top-level policy.
"""
from __future__ import annotations

import torch
import torch.utils.checkpoint
from torch.utils.checkpoint import (CheckpointPolicy,
                                    create_selective_checkpoint_contexts)

from repro_torch import device as device_mod
from repro_torch import prng
from repro_torch.configs.base import ModelCfg
from repro_torch.kernels import sharded
from repro_torch.kernels.td_vmm import ref as td_ref
from repro_torch.models import attention, common, ffn, mamba2, rwkv6
from repro_torch.tdsim import policy as td_policy
from repro_torch.tdsim import td_linear


MIXERS = ("attn", "shared_attn", "mamba2", "rwkv6")
FFNS = ("swiglu", "moe", "rwkv_cm", "none")


def _check_supported(cfg: ModelCfg) -> None:
    if cfg.family == "encdec":
        raise ValueError(f"{cfg.name}: an enc-dec model runs through "
                         "models.encdec (model_api's 'encdec' entry), not "
                         "the decoder stack")
    if cfg.family != "decoder":
        raise NotImplementedError(f"{cfg.name}: family {cfg.family!r} not "
                                  "yet ported (ROADMAP.md §1, step 13)")
    for i in range(cfg.n_layers):
        if cfg.mixer_at(i) not in MIXERS:
            raise ValueError(f"{cfg.name}: mixer {cfg.mixer_at(i)!r}")
        if _ffn_kind(cfg, i) not in FFNS:
            raise ValueError(f"{cfg.name}: ffn {_ffn_kind(cfg, i)!r}")


def _ffn_kind(cfg: ModelCfg, layer: int) -> str:
    if cfg.ffn_pattern is not None:
        return cfg.ffn_pattern[layer]
    if cfg.rwkv is not None:
        return "rwkv_cm"
    if cfg.moe is not None:
        return "moe"
    return "swiglu"


def _has_shared(cfg: ModelCfg) -> bool:
    return any(cfg.mixer_at(i) == "shared_attn" for i in range(cfg.n_layers))


def _is_homogeneous(cfg: ModelCfg) -> bool:
    """Whether every layer has the same structure (the stacked layout's
    condition): one mixer kind, one FFN kind, no shared-attention site."""
    mixers = {cfg.mixer_at(i) for i in range(cfg.n_layers)}
    ffns = {_ffn_kind(cfg, i) for i in range(cfg.n_layers)}
    return len(mixers) == 1 and len(ffns) == 1 and \
        "shared_attn" not in mixers


def _can_scan(cfg: ModelCfg, pol) -> bool:
    """Whether ``cfg`` runs in the stacked layout under ``pol``: a
    ``scan_layers`` config with a homogeneous stack, unless ``pol`` is a
    heterogeneous `NetworkPolicy` (per-layer policies, or any
    tensor-valued field, such as a sweep's per-lane sigmas), whose layers
    unroll.  ``pol`` None asks of the config alone."""
    if not (cfg.scan_layers and _is_homogeneous(cfg)):
        return False
    return not (isinstance(pol, td_policy.NetworkPolicy)
                and not pol.homogeneous)


def _layer_views(layers, n: int) -> list:
    """Per-layer trees of ``layers``: a list as it is, a stacked tree as
    views of its layers (one ``torch.unbind`` a leaf; the fill index
    ``idx`` of stacked caches, one for all layers, goes to every layer)."""
    if isinstance(layers, list):
        return layers
    out: list = [{} for _ in range(n)]
    for name, v in layers.items():
        if isinstance(v, dict):
            subs = _layer_views(v, n)
        elif name == "idx":
            subs = [v] * n
        else:
            subs = torch.unbind(v)
        for o, sub in zip(out, subs):
            o[name] = sub
    return out


def _stack_layers(trees: list, like=None, views=None) -> dict:
    """The stacked tree of per-layer ``trees`` (each leaf stacked along a
    new leading axis; a cache's fill index taken from the last layer, all
    layers' being equal).  With ``like``, a stacked tree, and ``views``,
    its per-layer views (`_layer_views`): a leaf that every layer returned
    as its view, written in place (the KV caches), stays ``like``'s
    stacked tensor, with no copy."""
    out = {}
    for name, v in trees[0].items():
        sub = [t[name] for t in trees]
        if isinstance(v, dict):
            out[name] = _stack_layers(
                sub, None if like is None else like[name],
                None if like is None else [w[name] for w in views])
        elif name == "idx":
            out[name] = sub[-1]
        elif like is not None and all(a is w[name]
                                      for a, w in zip(sub, views)):
            out[name] = like[name]
        else:
            out[name] = torch.stack(sub)
    return out


def _stacked_like(tree: dict, n: int, make) -> dict:
    """A stacked tree for ``n`` layers shaped as the one-layer ``tree``,
    each leaf ``make((n, *shape), dtype, device)``; a fill index ``idx``
    is kept as it is (one for all layers)."""
    return {k: _stacked_like(v, n, make) if isinstance(v, dict)
            else v if k == "idx"
            else make((n, *v.shape), dtype=v.dtype, device=v.device)
            for k, v in tree.items()}


def _put_layer(stacked: dict, tree: dict, i: int) -> None:
    """Copy one layer's parameter ``tree`` into row i of ``stacked``."""
    for k, v in tree.items():
        if isinstance(v, dict):
            _put_layer(stacked[k], v, i)
        else:
            stacked[k][i] = v


def init_params(seed: int, cfg: ModelCfg, pol, dtype=torch.float32,
                device=None) -> dict:
    """Seeded random parameters with the reference's distributions and
    layout: every layer has ``ln1`` and ``ln2`` (a mixer-only layer's
    ``ln2`` too), and a shared attention block lives once, under
    ``shared_attn``, initialised under the top-level policy.  Each tensor
    is drawn in float32 on ``device`` and stored in ``dtype``.  When
    `_can_scan` holds, ``layers`` is one stacked tree, each layer drawn as
    the unrolled init draws it and copied into its row: the stacked
    params equal the unrolled ones stacked, bit for bit."""
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
    if _has_shared(cfg):
        params["shared_attn"] = attention.attn_init(gen, cfg, top, dtype,
                                                    dev)
    scan = _can_scan(cfg, pol)
    layers: list | dict = []
    for i in range(cfg.n_layers):
        pol_i = common.pol_at(pol, i)
        lp = {"ln1": common.rmsnorm_init(cfg.d_model, dtype, dev),
              "ln2": common.rmsnorm_init(cfg.d_model, dtype, dev)}
        mix = cfg.mixer_at(i)
        if mix == "attn":
            lp["attn"] = attention.attn_init(gen, cfg, pol_i, dtype, dev)
        elif mix == "mamba2":
            lp["mamba"] = mamba2.mamba2_init(gen, cfg, pol_i, dtype, dev)
        elif mix == "rwkv6":
            lp["timemix"] = rwkv6.timemix_init(gen, cfg, pol_i, dtype, dev)
        fk = _ffn_kind(cfg, i)
        if fk == "swiglu":
            lp["mlp"] = ffn.swiglu_init(gen, cfg.d_model, cfg.d_ff, pol_i,
                                        dtype, dev)
        elif fk == "moe":
            lp["moe"] = ffn.moe_init(gen, cfg.d_model, cfg.moe, pol_i, dtype,
                                     dev)
        elif fk == "rwkv_cm":
            lp["chanmix"] = rwkv6.chanmix_init(gen, cfg, pol_i, dtype, dev)
        if not scan:
            layers.append(lp)
            continue
        if i == 0:
            layers = _stacked_like(lp, cfg.n_layers, torch.empty)
        _put_layer(layers, lp, i)
    params["layers"] = layers
    params["final_norm"] = common.rmsnorm_init(cfg.d_model, dtype, dev)
    if not cfg.tie_embeddings:
        params["lm_head"] = common.dense_init(
            gen, cfg.d_model, cfg.vocab, top, dtype=dtype,
            scale=1.0 / cfg.d_model ** 0.5, device=dev)
    return params


def _layer_apply(lp: dict, shared: dict | None, x: torch.Tensor,
                 cfg: ModelCfg, dense, i: int, positions: torch.Tensor,
                 cache: dict | None, key, attn_pols=None, pol=None,
                 moe=None, fold=None) -> tuple[torch.Tensor, dict | None,
                                                dict]:
    """One layer: its structure and policy those of layer ``i``, its
    mixer's and FFN's key paths ``fold`` (a pair of tuples; None: the
    unrolled ``(2i,)`` and ``(2i + 1,)``)."""
    mixer = cfg.mixer_at(i)
    # the shared block's denses run at the top-level policy: layer None
    at = None if mixer == "shared_attn" else i
    f_mix, f_ffn = ((2 * i,), (2 * i + 1,)) if fold is None else fold

    def mix(p, h, j):
        return dense(at, (*f_mix, j), p, h)

    def mlp(p, h, j):
        return dense(i, (*f_ffn, j), p, h)

    kmix = common.fold_key(key, *f_mix)
    h = common.rmsnorm(lp["ln1"], x, cfg.rms_eps)
    if mixer in ("attn", "shared_attn"):
        y, new_cache = attention.attention(
            lp["attn"] if mixer == "attn" else shared, h, cfg, None,
            positions, cache=cache, key=kmix, attn_pols=attn_pols,
            dense=mix)
    elif mixer == "mamba2":
        y, new_cache = mamba2.mamba2(lp["mamba"], h, cfg, None, state=cache,
                                     dense=mix)
    else:
        y, new_cache = rwkv6.timemix(lp["timemix"], h, cfg, None,
                                     state=cache, dense=mix)
    # on a mesh: the mixer's partial sums reduced, the stream batch-split
    x = common.maybe_constrain(x + y, common.batch_sharding_axes(), None,
                               None)

    fk = _ffn_kind(cfg, i)
    if fk == "none":
        return x, new_cache, {}
    h = common.rmsnorm(lp["ln2"], x, cfg.rms_eps)
    if fk == "moe":
        if moe is None:
            y, aux = ffn.moe_ffn(lp["moe"], h, cfg.moe,
                                 common.pol_at(pol, i),
                                 common.fold_key(key, *f_ffn))
        else:
            y, aux = moe(i, lp["moe"], h), {}
        return x + y, new_cache, aux
    if fk == "swiglu":
        return x + ffn.swiglu(lp["mlp"], h, None, dense=mlp), new_cache, {}
    cm_state = cache if cache is not None and "shift_c" in cache else None
    y, cm_new = rwkv6.chanmix(lp["chanmix"], h, cfg, None, state=cm_state,
                              dense=mlp)
    if new_cache is not None and cm_new is not None:
        new_cache = {**new_cache, **cm_new}
    return x + y, new_cache, {}


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
          caches: list | dict | None = None, remat: str = "none",
          layers: range | None = None, pol=None, moe=None,
          scan: bool = False) -> tuple[torch.Tensor, list | dict, dict]:
    """The decoder's layers in order (``layers``: a range of them, all by
    default), shared by `forward` and `forward_lanes`; the parameters and
    caches in either layout.  ``dense(i, fold, p, h)`` computes a dense of
    layer i with params p on h, i None for a dense at the top-level policy
    (the shared attention block's); ``fold`` is the dense's key path from
    the forward's key, ``(2i, j)`` for the mixer's j-th dense and ``(2i +
    1, j)`` for the FFN's.  ``key`` seeds TD attention (``fold_key(key,
    2i, 4)``) and the MoE's experts (``fold_key(key, 2i + 1)``), which run
    at ``pol_at(pol, i)`` (`ffn.moe_ffn`); ``moe(i, p, h)``, when given,
    computes layer i's MoE FFN in their place (no aux losses).  ``scan``
    runs the reference's scan body instead: layer i at layer 0's structure
    and policy, on the key paths ``(i, 0, j)`` and ``(i, 1, j)`` (TD
    attention ``(i, 0, 4)``, the experts ``(i, 1)``), its aux losses
    summed as one sum over the layers, list caches stacked first.
    ``remat``: "full" recomputes each layer in the backward from its
    input, "dots" keeps its unbatched matmuls' results and recomputes the
    rest.  Returns (x, the layers' new caches: stacked when scanning or
    when they came stacked, else a list with None where a layer has no
    cache, the layers' aux losses)."""
    n = cfg.n_layers
    lps = _layer_views(params["layers"], n)
    stacked = isinstance(caches, dict)
    if scan and isinstance(caches, list):
        caches, stacked = _stack_layers(caches), True
    views = None if caches is None else _layer_views(caches, n)
    new_caches: list = [None] * n
    aux_all: dict = {}
    auxes: list = []
    for i in (range(n) if layers is None else layers):
        cache = views[i] if views is not None else None
        at, fold = (0, ((i, 0), (i, 1))) if scan else (i, None)
        args = (lps[i], params.get("shared_attn"), x, cfg, dense, at,
                positions, cache, key, attn_pols, pol, moe, fold)
        if remat == "none":
            x, new_caches[i], aux = _layer_apply(*args)
        else:
            x, new_caches[i], aux = torch.utils.checkpoint.checkpoint(
                _layer_apply, *args, use_reentrant=False,
                preserve_rng_state=False,
                **({"context_fn": _dots_contexts} if remat == "dots"
                   else {}))
        # on a mesh the residual stream leaves each layer batch-split and
        # whole in d (the tensor-parallel partial sums reduced)
        x = common.maybe_constrain(x, common.batch_sharding_axes(), None,
                                   None)
        if scan:
            auxes.append(aux)
            continue
        for name, v in aux.items():
            aux_all[name] = aux_all[name] + v if name in aux_all else v
    if auxes and auxes[0]:
        aux_all = {name: torch.stack([a[name] for a in auxes]).sum()
                   for name in auxes[0]}
    if stacked:
        return x, _stack_layers(new_caches, caches, views), aux_all
    return x, new_caches, aux_all


def _policy_dense(pol, key):
    """`_walk`'s ``dense`` for one forward: layer i at ``pol_at(pol, i)``
    (i None: ``pol_top(pol)``), its noise seeded by ``fold_key(key,
    *fold)``."""
    top = common.pol_top(pol)

    def dense(i, fold, p, h):
        return td_linear.linear(p, h, top if i is None else
                                common.pol_at(pol, i),
                                common.fold_key(key, *fold))
    return dense


def _head(params: dict, x: torch.Tensor, cfg: ModelCfg, top, key
          ) -> torch.Tensor:
    """Final norm and lm_head (under ``fold_key(key, 10_000)``), or with
    tied embeddings the plain product with the embedding table."""
    x = common.rmsnorm(params["final_norm"], x, cfg.rms_eps)
    if cfg.tie_embeddings:
        logits = x @ sharded.gather_dp(params["embed"]["table"]).T
    else:
        logits = common.dense(params["lm_head"], x, top,
                              common.fold_key(key, 10_000))
    # keep the (huge) logits vocab-sharded; CE's logsumexp reduces over it
    return common.maybe_constrain(logits, common.batch_sharding_axes(), None,
                                  "model")


def _embed(params: dict, batch: dict, cfg: ModelCfg, pol) -> torch.Tensor:
    """The token embeddings, after the adapter's projection of a stub
    frontend's ``embeds`` when the batch has them (the adapter runs at the
    top-level policy with no key, as in the reference)."""
    x = common.embed(params["embed"], batch["tokens"])
    if cfg.frontend is not None and "embeds" in batch:
        emb = common.dense(params["adapter"], batch["embeds"],
                           common.pol_top(pol))
        x = torch.cat([emb.to(x.dtype), x], dim=1)
    return common.maybe_constrain(x, common.batch_sharding_axes(), None, None)


def forward(params: dict, batch: dict, cfg: ModelCfg, pol,
            caches: list | dict | None = None,
            positions: torch.Tensor | None = None,
            key=None, remat: str = "none"
            ) -> tuple[torch.Tensor, list | dict | None, dict]:
    """Returns (logits, new_caches, aux).  batch: {"tokens": (B, S)} and,
    for a stub frontend, {"embeds": (B, Nv, d_frontend)}: the logits then
    cover the Nv frontend positions first.

    The parameters and caches come in either layout.  When `_can_scan`
    holds the layers run as the reference's scan (the module docstring's
    seeds and aux sum) and the new caches come back stacked (list caches
    are stacked first, as the reference stacks them); a list of layer
    parameters is read in place, the values a stack of it would hold.
    Otherwise the layers unroll, on views of stacked parameters, and the
    caches come back in the layout they came in.

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
                               remat, pol=pol, scan=_can_scan(cfg, pol))
    logits = _head(params, x, cfg, common.pol_top(pol), key)
    return logits, (new_caches if caches is not None else None), aux


# the lanes' seeded denses of a layer by kind, counted along their key paths
# (2i, j) (the mixer's) and (2i + 1, j) (the FFN's); the MoE's experts are
# seeded apart, E a projection, and the shared block (at the top-level
# policy) runs lane by lane with each lane's key
_MIXER_DENSES = {"attn": 4, "shared_attn": 0, "mamba2": 2, "rwkv6": 5}
_FFN_DENSES = {"swiglu": 3, "rwkv_cm": 3, "moe": 0, "none": 0}


@torch.no_grad()
def forward_lanes(params: dict, batch: dict, cfg: ModelCfg, base_pol,
                  sigma: torch.Tensor, keys, top_pol) -> torch.Tensor:
    """P probes in one pass, on every decoder family: ``batch``
    {"tokens": (B, S)} (and a stub frontend's "embeds") shared, ``sigma``
    (P, n_layers) each probe's noise std per layer (on the tokens'
    device), ``keys`` P raw PRNG keys.  Layer i of lane p runs
    ``base_pol`` at ``sigma[p, i]``; the embeddings' adapter, the shared
    attention block (zamba2) and lm_head run ``top_pol``.  Returns (P, B,
    S', vocab) logits (S' counts a frontend's positions first); lane p
    equals ``forward(params, batch, cfg, NetworkPolicy(layers=(base_pol.
    replace(sigma_chain=sigma[p, i]), ...), top=top_pol), key=keys[p])``
    bit for bit.

    The layers before the first one where any lane's sigma is nonzero run
    once for all lanes (at sigma 0 the noise term is exactly zero; a noisy
    ``top_pol`` ends that prefix before the first shared site); from there
    the lanes fold into the batch, lane major.  Every td dense of a layer
    is one td_vmm launch over the P lanes with the shared weight; the
    MoE routes and slots each lane's tokens apart (its capacity is a
    single pass's) and runs the P x E expert products of a projection in
    one launch (`ffn.moe_ffn_lanes`); mamba2's and rwkv6's scans start
    every folded row at a zero state, as `forward` does.  The shared
    block's denses run at ``top_pol`` and lm_head, lane by lane, each in a
    single pass's shapes with its lane's key.  Reading the first noisy
    layer costs one copy of ``sigma`` to the host a call, and the lanes'
    seeds of every dense one copy to the device."""
    _check_supported(cfg)
    p_lanes, n_layers = len(keys), cfg.n_layers
    if tuple(sigma.shape) != (p_lanes, n_layers):
        raise ValueError(f"sigma {tuple(sigma.shape)} for {p_lanes} keys "
                         f"and {n_layers} layers")
    noisy = (sigma != 0).any(0).tolist()
    first = noisy.index(True) if any(noisy) else n_layers
    if top_pol.mode == "td" and float(top_pol.sigma_chain) != 0:
        first = min([first] + [i for i in range(n_layers)
                               if cfg.mixer_at(i) == "shared_attn"])
    x = _embed(params, batch, cfg, top_pol)
    b, s, d = x.shape
    dev = x.device
    positions = torch.arange(s, device=dev)
    clean = td_policy.NetworkPolicy(
        layers=(base_pol.replace(sigma_chain=0.0),) * n_layers, top=top_pol)
    x, _, _ = _walk(params, x, cfg, _policy_dense(clean, None), positions,
                    layers=range(first), pol=clean)

    # the seeds of every lane dense, a column each, then E a projection of
    # each MoE layer's experts
    folds = [(2 * i + part, j) for i in range(first, n_layers)
             for part, n_dense in ((0, _MIXER_DENSES[cfg.mixer_at(i)]),
                                   (1, _FFN_DENSES[_ffn_kind(cfg, i)]))
             for j in range(n_dense)]
    col = {f: c for c, f in enumerate(folds)}
    moe_layers = [i for i in range(first, n_layers)
                  if _ffn_kind(cfg, i) == "moe"]
    n_exp = cfg.moe.num_experts if moe_layers else 0
    moe_col = {i: len(folds) + 3 * n_exp * c
               for c, i in enumerate(moe_layers)}

    def lane_seeds(k) -> list[int]:
        row = [td_ref.derive_seed(common.fold_key(k, *f)) for f in folds]
        for i in moe_layers:
            for j in range(3):
                row += [td_ref.derive_seed(ke) for ke in prng.split(
                    common.fold_key(k, 2 * i + 1, j), n_exp)]
        return row

    seeds = torch.tensor([lane_seeds(k) for k in keys], dtype=torch.int64,
                         device=dev)
    tdc_q = torch.full((p_lanes,), float(base_pol.tdc_q),
                       dtype=torch.float32, device=dev)
    sigma = sigma.to(torch.float32)

    def lane_dense(i, fold, p, h):
        hl = h.reshape(p_lanes, -1, *h.shape[1:])
        if i is None:
            y = torch.stack([td_linear.linear(p, hl[q], top_pol,
                                              common.fold_key(keys[q], *fold))
                             for q in range(p_lanes)])
        else:
            y = td_linear.linear_lanes(p, hl, base_pol, sigma[:, i], tdc_q,
                                       seeds[:, col[fold]])
        return y.reshape(*h.shape[:-1], y.shape[-1])

    def lane_moe(i, p, h):
        c = moe_col[i]
        return ffn.moe_ffn_lanes(
            p, h, cfg.moe, base_pol, sigma[:, i], tdc_q,
            seeds[:, c:c + 3 * n_exp].reshape(p_lanes, 3, n_exp))

    x = x.expand(p_lanes, b, s, d).reshape(p_lanes * b, s, d)
    x, _, _ = _walk(params, x, cfg, lane_dense, positions,
                    layers=range(first, n_layers), moe=lane_moe)
    x = x.reshape(p_lanes, b, s, d)
    return torch.stack([_head(params, x[p], cfg, top_pol, keys[p])
                        for p in range(p_lanes)])


def _layer_cache(i: int, b: int, s_cache: int, cfg: ModelCfg, dtype, dev,
                 per_row_idx: bool) -> dict:
    mixer = cfg.mixer_at(i)
    if mixer in ("attn", "shared_attn"):
        return attention.init_cache(b, s_cache, cfg, dtype, dev, per_row_idx)
    if mixer == "mamba2":
        return mamba2.init_state(b, cfg, torch.float32, dev)
    return rwkv6.init_state(b, cfg, torch.float32, dev)


def init_caches(b: int, s_cache: int, cfg: ModelCfg, dtype=torch.bfloat16,
                device=None, per_row_idx: bool = False, pol=None
                ) -> list | dict:
    """One cache per layer: a KV cache (``dtype``) for an attention or
    shared-attention layer, a float32 decode state for a mamba2 or rwkv6
    layer, whatever ``dtype``.  ``per_row_idx`` builds the serving engine's
    ragged-slot KV caches (one fill index per batch row).  ``pol`` is the
    policy the forward will run under: when `_can_scan(cfg, pol)` holds
    the caches are one stacked tree, zeros with one fill index (a
    heterogeneous `NetworkPolicy` keeps the list on a ``scan_layers``
    config; None asks of the config alone)."""
    _check_supported(cfg)
    dev = common.state_device(device)
    if _can_scan(cfg, pol):
        one = _layer_cache(0, b, s_cache, cfg, dtype, dev, per_row_idx)
        return common.place_state(_stacked_like(one, cfg.n_layers,
                                                torch.zeros))
    return common.place_state([
        _layer_cache(i, b, s_cache, cfg, dtype, dev, per_row_idx)
        for i in range(cfg.n_layers)])
