"""RWKV-6 "Finch" (arXiv:2404.05892): attention-free time mixing with a
data-dependent decay, and the RWKV channel-mix FFN (port of
`repro/models/rwkv6.py`).

Token-shift ddlerp with a low-rank dynamic mix, the decay w_t =
exp(-exp(w0 + tanh(x W_a) W_b)) per channel, the bonus u, a per-head wkv
state S in R^{hd x hd}, a group norm on the heads' outputs and the
sigmoid-receptance channel mix.  The wkv6 recurrence is a loop over time
in float32 (the reference's ``lax.scan``; training and prefill) and one
update a token in decode.  The LoRA products and the scan are plain
torch, as the reference's are jnp; the denses run through the ``dense``
callback (td_vmm in td mode).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelCfg
from repro_torch.kernels import sharded
from repro_torch.models import common
from repro_torch.models.ffn import silu
from repro_torch.roofline import counter

MIX_NAMES = ("r", "k", "v", "w", "g")


def dims(cfg: ModelCfg) -> tuple[int, int]:
    hd = cfg.rwkv.head_dim
    return cfg.d_model // hd, hd           # (n_heads, head_dim)


def _normal(gen, shape, std, device) -> torch.Tensor:
    return torch.randn(shape, generator=gen, dtype=torch.float32,
                       device=device) * std


def timemix_init(gen: torch.Generator, cfg: ModelCfg, pol,
                 dtype=torch.float32, device=None) -> dict:
    """The time mix's leaves under the reference's names, drawn from
    ``gen`` in float32 and stored in ``dtype``."""
    d = cfg.d_model
    nh, hd = dims(cfg)
    r_mix, r_dec = cfg.rwkv.mix_lora, cfg.rwkv.decay_lora

    def full(val):
        return torch.full((d,), val, dtype=dtype, device=device)
    p = {
        # static token-shift mixes
        "mu": {m: full(0.5) for m in MIX_NAMES},
        # shared dynamic-mix LoRA trunk: d -> 5 r_mix -> 5 d
        "mix_w1": _normal(gen, (d, 5 * r_mix), 0.01, device).to(dtype),
        "mix_w2": _normal(gen, (5, r_mix, d), 0.01, device).to(dtype),
        # data-dependent decay LoRA
        "w0": full(-2.0),
        "dec_a": _normal(gen, (d, r_dec), 0.01, device).to(dtype),
        "dec_b": _normal(gen, (r_dec, d), 0.01, device).to(dtype),
        "u": _normal(gen, (nh, hd), 0.1, device).to(dtype),
    }
    for name in ("wr", "wk", "wv", "wg"):
        p[name] = common.dense_init(gen, d, d, pol, dtype=dtype,
                                    device=device)
    p["wo"] = common.dense_init(gen, d, d, pol, dtype=dtype,
                                scale=1.0 / d ** 0.5, device=device)
    p["ln_x"] = {"scale": full(1.0), "bias": full(0.0)}
    return p


def _token_shift(x: torch.Tensor, last: torch.Tensor | None) -> torch.Tensor:
    """The previous token's tensor; ``last`` (B, 1, d) is the decode carry
    (at S = 1 it is the whole shift)."""
    if last is None:
        return torch.nn.functional.pad(x, (0, 0, 1, 0))[:, :-1]
    if x.shape[1] > 1:
        return torch.cat([last.to(x.dtype), x], dim=1)[:, :-1]
    return last.to(x.dtype)


def _f32_mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` for float32 x, with the reference's promotion of a bf16
    w to float32 (exact)."""
    return x @ w.to(torch.float32)


def _ddlerp(params: dict, x: torch.Tensor, xx: torch.Tensor) -> dict:
    """The data-dependent lerp between x and the shifted xx (both float32)
    for the five mixes; the LoRA products in float32."""
    base = x + (xx - x) * 0.5
    low = torch.tanh(_f32_mm(base, params["mix_w1"]))      # (B, S, 5r)
    b, s, _ = low.shape
    low = low.reshape(b, s, 5, -1)
    dyn = torch.einsum("bsfr,frd->bsfd", low,
                       params["mix_w2"].to(torch.float32))  # (B, S, 5, d)
    return {m: x + (xx - x) * (params["mu"][m] + dyn[:, :, i])
            for i, m in enumerate(MIX_NAMES)}


def wkv6_scan(r, k, v, w, u, s0=None):
    """The wkv6 recurrence, a loop over time in float32.  r, k, v, w (B, S,
    H, hd); u (H, hd); ``s0`` an optional initial state (B, H, hd, hd).
    S_t = diag(w_t) S_{t-1} + k_t v_t^T; y_t = r_t . (S_{t-1} + (u k_t)
    v_t^T), computed as r_t . S_{t-1} + (r_t . (u k_t)) v_t: the bonus
    term runs for all t at once, and a step is one product and two
    elementwise updates.  Returns y (B, S, H, hd) and the final state
    (B, H, hd, hd)."""
    b, s, h, hd = r.shape
    f32 = torch.float32
    r, k, v, w = (t.to(f32) for t in (r, k, v, w))
    bonus = (r * u[None, None] * k).sum(-1, keepdim=True) * v
    state = (torch.zeros((b, h, hd, hd), dtype=f32, device=r.device)
             if s0 is None else s0)
    if s > 1 and counter.active() is not None:
        # counted, not run: one step, counted s times (the dry run)
        def step(r0, k0, v0, w0, st):
            y = torch.matmul(r0[:, :, None, :], st)[:, :, 0]
            return y, torch.addcmul(w0[..., None] * st, k0[..., None],
                                    v0[:, :, None, :])
        def count(*a):
            return counter.repeat("wkv6", s, step, *a)
        args = [r[:, 0], k[:, 0], v[:, 0], w[:, 0], state]
        if sharded.mesh_of(*args) is not None:
            # per (batch row, head): on local shards
            y1, state = sharded.local_call(
                count, args, [((0,) * 5, (0, 0)), ((1,) * 5, (1, 1))])
        else:
            y1, state = count(*args)
        return y1[:, None].expand(b, s, h, hd) + bonus, state
    ys = []
    for t in range(s):
        ys.append(torch.matmul(r[:, t, :, None, :], state)[:, :, 0])
        state = torch.addcmul(w[:, t, :, :, None] * state,
                              k[:, t, :, :, None], v[:, t, :, None, :])
    return torch.stack(ys, dim=1) + bonus, state


def timemix(params: dict, x: torch.Tensor, cfg: ModelCfg, pol,
            state: dict | None = None, key=None, dense=None
            ) -> tuple[torch.Tensor, dict | None]:
    """x (B, S, d) -> (y, new_state).  ``state`` {"wkv", "shift_t", ...}
    turns on the decode carry (S > 1: the scan seeded with it; S = 1: one
    update).  ``dense(p, h, j)`` computes wr, wk, wv, wg, wo (j 0..4);
    None means ``common.dense(p, h, pol, fold_key(key, j))``."""
    b, s, d = x.shape
    nh, hd = dims(cfg)
    f32 = torch.float32
    if dense is None:
        def dense(p, h, j):
            return common.dense(p, h, pol, common.fold_key(key, j))
    last = state["shift_t"] if state is not None else None
    xx = _token_shift(x, last)
    mixes = _ddlerp(params, x.to(f32), xx.to(f32))

    r = dense(params["wr"], mixes["r"].to(x.dtype), 0)
    k = dense(params["wk"], mixes["k"].to(x.dtype), 1)
    v = dense(params["wv"], mixes["v"].to(x.dtype), 2)
    g = dense(params["wg"], mixes["g"].to(x.dtype), 3)
    w_dyn = params["w0"] + _f32_mm(
        torch.tanh(_f32_mm(mixes["w"], params["dec_a"])), params["dec_b"])
    w = torch.exp(-torch.exp(w_dyn.to(f32)))              # (B, S, d) in (0, 1)

    rh = r.reshape(b, s, nh, hd).to(f32)
    kh = k.reshape(b, s, nh, hd).to(f32)
    vh = v.reshape(b, s, nh, hd).to(f32)
    wh = w.reshape(b, s, nh, hd)
    u = params["u"].to(f32)

    if state is None:
        y, _ = wkv6_scan(rh, kh, vh, wh, u)
        new_state = None
    elif s > 1:
        # prefill into a decode state
        y, s_fin = wkv6_scan(rh, kh, vh, wh, u, s0=state["wkv"].to(f32))
        new_state = {"wkv": s_fin.to(state["wkv"].dtype),
                     "shift_t": x[:, -1:, :]}
    else:
        big_s = state["wkv"].to(f32)                       # (B, H, hd, hd)
        kv = kh[:, 0, :, :, None] * vh[:, 0, :, None, :]
        y = torch.matmul(rh[:, 0, :, None, :],
                         big_s + u[None, :, :, None] * kv)[:, :, 0][:, None]
        s_new = wh[:, 0, :, :, None] * big_s + kv
        new_state = {"wkv": s_new.to(state["wkv"].dtype),
                     "shift_t": x[:, -1:, :]}

    # group norm over each head (population variance, as jnp.var), then
    # the gate
    yh = y.reshape(b, s, nh, hd)
    mu = yh.mean(-1, keepdim=True)
    var = yh.var(-1, keepdim=True, correction=0)
    yn = ((yh - mu) * torch.rsqrt(var + 1e-5)).reshape(b, s, d)
    yn = yn * params["ln_x"]["scale"] + params["ln_x"]["bias"]
    out = dense(params["wo"], (yn * silu(g.to(f32))).to(x.dtype), 4)
    return out, new_state


def chanmix_init(gen: torch.Generator, cfg: ModelCfg, pol,
                 dtype=torch.float32, device=None) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    return {
        "mu_k": torch.full((d,), 0.5, dtype=dtype, device=device),
        "mu_r": torch.full((d,), 0.5, dtype=dtype, device=device),
        "wk": common.dense_init(gen, d, f, pol, dtype=dtype, device=device),
        "wv": common.dense_init(gen, f, d, pol, dtype=dtype,
                                scale=1.0 / f ** 0.5, device=device),
        "wr": common.dense_init(gen, d, d, pol, dtype=dtype, device=device),
    }


def chanmix(params: dict, x: torch.Tensor, cfg: ModelCfg, pol,
            state: dict | None = None, key=None, dense=None
            ) -> tuple[torch.Tensor, dict | None]:
    """The channel mix: sigmoid(x_r W_r) * (relu(x_k W_k)^2 W_v).
    ``state`` {"shift_c", ...} carries the last token; ``dense(p, h, j)``
    computes wk, wv, wr (j 0..2); None means ``common.dense(p, h, pol,
    fold_key(key, j))``."""
    if dense is None:
        def dense(p, h, j):
            return common.dense(p, h, pol, common.fold_key(key, j))
    last = state["shift_c"] if state is not None else None
    xx = _token_shift(x, last)
    xk = x + (xx - x) * params["mu_k"]
    xr = x + (xx - x) * params["mu_r"]
    k = torch.square(torch.relu(dense(params["wk"], xk, 0)))
    kv = dense(params["wv"], k, 1)
    r = torch.sigmoid(dense(params["wr"], xr, 2))
    new_state = {"shift_c": x[:, -1:, :]} if state is not None else None
    return r * kv, new_state


def init_state(b: int, cfg: ModelCfg, dtype=torch.float32,
               device=None) -> dict:
    """A layer's decode carry: the wkv state and both token shifts."""
    nh, hd = dims(cfg)
    d = cfg.d_model
    return {"wkv": torch.zeros((b, nh, hd, hd), dtype=dtype, device=device),
            "shift_t": torch.zeros((b, 1, d), dtype=dtype, device=device),
            "shift_c": torch.zeros((b, 1, d), dtype=dtype, device=device)}
