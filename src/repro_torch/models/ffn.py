"""FFNs (port of `repro/models/ffn.py`): the SwiGLU dense MLP and the
top-k MoE with sort-based capacity dispatch.

The MoE routes each token to its top-k experts, slots the (token, expert)
pairs into a fixed per-expert capacity Cap = ceil(T k cf / E) by a stable
sort (overflow dropped), runs the experts as E lanes of one batched matmul
a projection (`td_linear.td_matmul_experts`: one td_vmm launch over the E
lanes in td mode) and combines the slots weighted by router probability.
`moe_ffn_lanes` runs P probes of the batched noise search at once: each
probe routes and slots its own tokens, and a projection's P x E expert
products are one launch.
Under an active mesh the MoE's slots are constrained as the reference's
(`common.maybe_constrain`: experts over 'model', capacity over 'data').
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import MoECfg
from repro_torch.models import common
from repro_torch.quant import lsq
from repro_torch.tdsim import td_linear


def swiglu_init(gen: torch.Generator, d: int, d_ff: int, pol,
                dtype=torch.float32, device=None) -> dict:
    return {"wi": common.dense_init(gen, d, d_ff, pol, dtype=dtype,
                                    device=device),
            "wg": common.dense_init(gen, d, d_ff, pol, dtype=dtype,
                                    device=device),
            "wo": common.dense_init(gen, d_ff, d, pol, dtype=dtype,
                                    scale=1.0 / d_ff ** 0.5, device=device)}


def silu(x: torch.Tensor) -> torch.Tensor:
    """x * (1 / (1 + exp(-x))), one rounding per op in x's dtype: the
    expansion of the reference's ``jax.nn.silu``.  In bf16 it agrees with
    the reference bit for bit, where ``F.silu`` (one rounding) does not."""
    return x * (1.0 / (1.0 + torch.exp(-x)))


def swiglu(params: dict, x: torch.Tensor, pol, key=None,
           dense=None) -> torch.Tensor:
    """``dense(p, h, j)`` computes the j-th dense (wg, wi, wo: 0, 1, 2);
    None means ``common.dense(p, h, pol, fold_key(key, j))``."""
    if dense is None:
        def dense(p, h, j):
            return common.dense(p, h, pol, common.fold_key(key, j))
    h = silu(dense(params["wg"], x, 0)) * dense(params["wi"], x, 1)
    return dense(params["wo"], h, 2)


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------
def moe_init(gen: torch.Generator, d: int, moe: MoECfg, pol,
             dtype=torch.float32, device=None) -> dict:
    """Router (d, E) and expert stacks wi, wg (E, d, f) and wo (E, f, d)
    with the reference's distributions; when quantized one LSQ step
    ``s_wi`` / ``s_wg`` / ``s_wo`` a stack (from the whole stack) and one
    ``s_a`` for all three.  Drawn in float32, stored in ``dtype``."""
    e, f = moe.num_experts, moe.d_ff_expert

    def normal(shape, std):
        return torch.randn(shape, generator=gen, dtype=torch.float32,
                           device=device) * std

    std = 1.0 / d ** 0.5
    p = {"router": {"w": normal((d, e), std)},
         "wi": normal((e, d, f), std),
         "wg": normal((e, d, f), std),
         "wo": normal((e, f, d), 1.0 / f ** 0.5)}
    if pol.mode != "precise":
        for nm in ("wi", "wg", "wo"):
            p[f"s_{nm}"] = lsq.init_step_size(p[nm], pol.bits_w, signed=True)
        p["s_a"] = torch.tensor(2.0 / (lsq.qrange(pol.bits_a, True)[1] ** 0.5),
                                dtype=torch.float32, device=device)
    return common.cast_tree(p, dtype)


def _capacity(t: int, moe: MoECfg) -> int:
    cap = int(-(-t * moe.top_k * moe.capacity_factor // moe.num_experts))
    return max(moe.top_k, min(cap, t))


def top_k(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k`` along the last dim: the k largest, descending, the
    lower index first among equal values (a stable descending sort;
    ``torch.topk`` promises no order among ties)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _div(a: torch.Tensor, n: int) -> torch.Tensor:
    """``a / n`` as a true division (on CUDA torch multiplies by 1/n for a
    Python divisor); the divisor is filled on the device, not copied."""
    return a / torch.full((), n, dtype=a.dtype, device=a.device)


def _route(params: dict, xt: torch.Tensor, moe: MoECfg) -> dict:
    """Routing and sort-based slotting of one batch's T tokens xt (T, d):
    the router's logits and probabilities, each token's top-k experts and
    the (token, expert) pairs slotted into E x Cap slots (Cap from this T),
    a stable sort by expert grouping them, overflow dropped."""
    t = xt.shape[0]
    e, k = moe.num_experts, moe.top_k
    cap = _capacity(t, moe)
    dev = xt.device
    logits = (xt @ params["router"]["w"]).to(torch.float32)       # (T, E)
    ex = torch.exp(logits - logits.amax(-1, keepdim=True).detach())
    probs = ex / ex.sum(-1, keepdim=True)
    top_p, top_e = top_k(probs, k)                                # (T, k)
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)

    flat_e = top_e.reshape(-1)                                    # (T*k,)
    sorted_e, order = torch.sort(flat_e, stable=True)
    group_start = torch.searchsorted(sorted_e,
                                     torch.arange(e, device=dev))
    rank = torch.arange(t * k, device=dev) - group_start[sorted_e]
    keep = rank < cap
    slot = torch.where(keep, sorted_e * cap + rank, e * cap)      # overflow
    token_of = order // k
    weight_of = top_p.reshape(-1)[order]
    # kept slots are distinct; every overflow pair writes the extra slot,
    # which is dropped
    slot_token = torch.zeros(e * cap + 1, dtype=torch.int64,
                             device=dev).scatter_(0, slot, token_of)[:-1]
    slot_weight = torch.zeros(e * cap + 1, dtype=torch.float32,
                              device=dev).scatter_(
        0, slot, torch.where(keep, weight_of, 0.0))[:-1]
    return {"cap": cap, "logits": logits, "probs": probs, "flat_e": flat_e,
            "keep": keep, "slot": slot, "order": order,
            "slot_token": slot_token, "slot_weight": slot_weight}


def _combine(r: dict, ys: torch.Tensor, moe: MoECfg) -> torch.Tensor:
    """(T, d) from the experts' (E, Cap, d) slots: each token sums its kept
    slots' contributions, weighted by router probability, in slot order."""
    e, k, cap = moe.num_experts, moe.top_k, r["cap"]
    t, d = r["keep"].shape[0] // k, ys.shape[-1]
    # on a mesh the combine reads every slot: gather them first
    ys = common.maybe_constrain(ys, None, None, None)
    ys_flat = ys.reshape(e * cap, d) * r["slot_weight"][:, None].to(ys.dtype)
    slot = r["slot"]
    pair_slot = torch.empty_like(slot).scatter_(0, r["order"], slot)
    pair_slot = torch.sort(pair_slot.reshape(t, k), dim=-1).values
    kept = pair_slot < e * cap
    contrib = ys_flat[torch.clamp(pair_slot, max=e * cap - 1)]    # (T, k, d)
    y = torch.zeros((t, d), dtype=ys.dtype, device=ys.device)
    for j in range(k):
        y = torch.where(kept[:, j, None], y + contrib[:, j], y)
    return y


def _aux(r: dict, moe: MoECfg) -> dict:
    """The Switch load-balance loss, the router z-loss and the dropped
    share of (token, expert) pairs, 0-d f32."""
    e, k = moe.num_experts, moe.top_k
    probs, flat_e, keep = r["probs"], r["flat_e"], r["keep"]
    t = probs.shape[0]
    me = _div(probs.sum(0), t)                                    # (E,)
    # counts (exact in f32) without bincount, which reads its size on the
    # host
    counts = torch.zeros(e, dtype=torch.float32,
                         device=probs.device).index_add_(
        0, flat_e, torch.ones(t * k, dtype=torch.float32,
                              device=probs.device))
    ce = _div(counts, t * k)
    aux = moe.aux_coef * e * (me * ce).sum()
    zloss = moe.router_z_coef * _div(
        (torch.logsumexp(r["logits"], dim=-1) ** 2).sum(), t)
    frac_dropped = 1.0 - _div(keep.to(torch.float32).sum(), t * k)
    return {"moe_aux": aux, "moe_z": zloss, "moe_dropped": frac_dropped}


def moe_ffn(params: dict, x: torch.Tensor, moe: MoECfg, pol, key=None
            ) -> tuple[torch.Tensor, dict]:
    """x (B, S, d) -> (y, aux): aux holds the Switch load-balance loss
    ``moe_aux``, the router z-loss ``moe_z`` and the dropped share of
    (token, expert) pairs ``moe_dropped``, 0-d f32.

    Capacity couples the rows of a batch: every token routes and takes
    slots, padded ones too, and a token past its expert's capacity is
    dropped, as in the reference.  The combine is deterministic: each
    token sums its kept slots' contributions in slot order (expert id),
    the reference's scatter-add order, in the experts' dtype, without
    atomics; the empty slots (token 0 at weight 0) add exact zeros and are
    skipped."""
    b, s, d = x.shape
    e = moe.num_experts
    # on a mesh the routing (a sort over every token) runs replicated:
    # the tokens are gathered here, where a real expert-parallel dispatch
    # would exchange only the routed ones
    xt = common.maybe_constrain(x.reshape(b * s, d), None, None)
    r = _route(params, xt, moe)
    xs = xt[r["slot_token"]].reshape(e, r["cap"], d)              # (E, C, d)
    # EP: grouped tokens live with their expert; the capacity dim shards
    # over 'data' (without it the expert products would be replicated
    # across the data axis)
    xs = common.maybe_constrain(xs, "model", "data", None)

    # ---- experts: lanes of one matmul a projection ------------------------
    def mm(h, nm, j):
        return td_linear.td_matmul_experts(
            h, params[nm], params.get("s_a"), params.get(f"s_{nm}"), pol,
            common.fold_key(key, j))

    h = silu(mm(xs, "wg", 0)) * mm(xs, "wi", 1)
    h = common.maybe_constrain(h, "model", "data", None)
    ys = mm(h, "wo", 2)                                           # (E, C, d)
    ys = common.maybe_constrain(ys, "model", "data", None)
    y = _combine(r, ys, moe).reshape(b, s, d).to(x.dtype)
    y = common.maybe_constrain(y, common.batch_sharding_axes(), None, None)
    return y, _aux(r, moe)


def moe_ffn_lanes(params: dict, x: torch.Tensor, moe: MoECfg, pol,
                  sigma: torch.Tensor, tdc_q: torch.Tensor,
                  seeds: torch.Tensor) -> torch.Tensor:
    """`moe_ffn` over P lanes folded into the batch, lane major (the
    batched noise search's probes), forward only: x (P B, S, d), lane p at
    ``pol`` with its ``sigma[p]`` and ``tdc_q[p]``.  ``seeds`` (P, 3, E)
    int64 are the experts' derived seeds of each projection (wg, wi, wo),
    lane p's ``derive_seed(split(fold_key(key_p, j), E)[e])`` for its FFN
    key key_p.  Returns y (P B, S, d); the aux losses are not computed.

    Each lane routes and slots its own B S tokens, so its capacity is a
    single pass's (folding the lanes into T would change which tokens are
    dropped); the P x E expert products of a projection are one td_vmm
    launch (`td_linear.td_matmul_expert_lanes`); each lane combines its
    own slots.  Lane p equals `moe_ffn` of lane p's rows at its policy and
    key bit for bit."""
    p_lanes = sigma.shape[0]
    pb, s, d = x.shape
    e = moe.num_experts
    xt = x.reshape(p_lanes, (pb // p_lanes) * s, d)
    routes = [_route(params, xt[p], moe) for p in range(p_lanes)]
    cap = routes[0]["cap"]
    xs = torch.stack([xt[p][r["slot_token"]].reshape(e, cap, d)
                      for p, r in enumerate(routes)])             # (P,E,C,d)

    def mm(h, nm, j):
        return td_linear.td_matmul_expert_lanes(
            h, params[nm], params.get("s_a"), params.get(f"s_{nm}"), pol,
            sigma, tdc_q, seeds[:, j])

    h = silu(mm(xs, "wg", 0)) * mm(xs, "wi", 1)
    ys = mm(h, "wo", 2)                                           # (P,E,C,d)
    y = torch.stack([_combine(r, ys[p], moe) for p, r in enumerate(routes)])
    return y.reshape(pb, s, d).to(x.dtype)
