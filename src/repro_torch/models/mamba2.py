"""Mamba-2 mixer (SSD, state space duality, arXiv:2405.21060) of the zamba2
hybrid (port of `repro/models/mamba2.py`).

Training and prefill: the chunked SSD algorithm (intra-chunk products by
segment sums, chunk states, and the inter-chunk recurrence as a Python
loop over the chunks in place of the reference's ``lax.scan``): O(S *
chunk) instead of O(S^2).  Decode: the single-step update of the (H, P, N)
SSM state and the rolling causal-conv window, O(1) a token.  The scans are
plain torch, as the reference's are jnp outside any Pallas kernel; the
two denses run through the ``dense`` callback (td_vmm in td mode).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelCfg
from repro_torch.models import common
from repro_torch.models.ffn import silu

NEG_INF = -1e30


def dims(cfg: ModelCfg) -> tuple[int, int, int, int, int]:
    """(d_inner, n_heads, head_dim, d_state, d_conv)."""
    ssm = cfg.ssm
    d_inner = ssm.expand * cfg.d_model
    n_heads = d_inner // ssm.head_dim
    return d_inner, n_heads, ssm.head_dim, ssm.d_state, ssm.d_conv


def mamba2_init(gen: torch.Generator, cfg: ModelCfg, pol,
                dtype=torch.float32, device=None) -> dict:
    """in_proj (d, 2 d_inner + 2 d_state + n_heads), the depthwise conv
    over x, B and C, out_proj (d_inner, d), drawn from ``gen`` in float32
    and stored in ``dtype``; ``dt_bias``, ``a_log`` and ``d_skip`` are
    deterministic, as in the reference."""
    d = cfg.d_model
    di, nh, hp, ns, dc = dims(cfg)
    d_xbc = di + 2 * ns                       # x + B + C (n_groups = 1)
    f32 = dict(dtype=torch.float32, device=device)
    in_proj = common.dense_init(gen, d, 2 * di + 2 * ns + nh, pol,
                                dtype=dtype, device=device)
    conv_w = torch.randn((dc, d_xbc), generator=gen, **f32) * 0.2
    out_proj = common.dense_init(gen, di, d, pol, dtype=dtype,
                                 scale=1.0 / di ** 0.5, device=device)
    return {
        "in_proj": in_proj,
        "conv_w": conv_w.to(dtype),
        "conv_b": torch.zeros((d_xbc,), dtype=dtype, device=device),
        "dt_bias": torch.log(torch.exp(torch.linspace(1e-3, 0.1, nh, **f32))
                             - 1.0).to(dtype),
        "a_log": torch.log(torch.linspace(1.0, 16.0, nh, **f32)).to(dtype),
        "d_skip": torch.ones((nh,), dtype=dtype, device=device),
        "norm": common.rmsnorm_init(di, dtype, device),
        "out_proj": out_proj,
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 state: torch.Tensor | None = None
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv along S.  x (B, S, C), w (K, C).  Returns the
    output and the trailing K - 1 inputs (the decode carry).  The taps are
    summed in the reference's order, one rounding each."""
    k, s = w.shape[0], x.shape[1]
    if state is None:
        xp = torch.nn.functional.pad(x, (0, 0, k - 1, 0))
    else:
        xp = torch.cat([state.to(x.dtype), x], dim=1)
    out = sum(xp[:, i:i + s, :] * w[i] for i in range(k))
    new_state = xp[:, xp.shape[1] - (k - 1):, :] if k > 1 else xp[:, :0, :]
    return out + b, new_state


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """a (..., L) -> (..., L, L): ``cs[i] - cs[j]`` on and below the
    diagonal (the summed log-decay from j to i), NEG_INF above it."""
    cs = torch.cumsum(a, dim=-1)
    ss = cs[..., :, None] - cs[..., None, :]
    n = a.shape[-1]
    mask = torch.tril(torch.ones((n, n), dtype=torch.bool, device=a.device))
    return torch.where(mask, ss, torch.full((), NEG_INF, dtype=ss.dtype,
                                            device=ss.device))


def ssd_chunked(x, dt, a, b_mat, c_mat, chunk: int, s0=None):
    """Chunked SSD.  x (B, S, H, P); dt (B, S, H); a (H,) negative;
    b_mat / c_mat (B, S, N); ``s0`` an optional initial state (B, H, P, N).
    Returns y (B, S, H, P) and the final state (B, H, P, N).

    The reference's four-operand intra-chunk einsum
    ``bcln,bcsn,bhcls,bcshp->bclhp`` runs as pairwise products, C B^T
    first, then the decay mask, then the product with x dt, so that no
    (B, C, L, L, H, P) intermediate is ever built."""
    bsz, s, h, p = x.shape
    n = b_mat.shape[-1]
    nc = -(-s // chunk)
    pad = nc * chunk - s
    if pad:
        x = torch.nn.functional.pad(x, (0, 0, 0, 0, 0, pad))
        dt = torch.nn.functional.pad(dt, (0, 0, 0, pad))
        b_mat = torch.nn.functional.pad(b_mat, (0, 0, 0, pad))
        c_mat = torch.nn.functional.pad(c_mat, (0, 0, 0, pad))
    el = chunk
    xc = x.reshape(bsz, nc, el, h, p)
    dtc = dt.reshape(bsz, nc, el, h)
    bc = b_mat.reshape(bsz, nc, el, n)
    cc = c_mat.reshape(bsz, nc, el, n)

    da = dtc * a[None, None, None, :]                 # (B, C, L, H) log-decay
    da_h = da.permute(0, 3, 1, 2)                     # (B, H, C, L)
    da_cum = torch.cumsum(da_h, dim=-1)               # (B, H, C, L)

    # intra-chunk (diagonal blocks)
    lmat = torch.exp(_segsum(da_h))                   # (B, H, C, L, L)
    xdt = xc * dtc[..., None]                         # input scaled by dt
    cb = torch.einsum("bcln,bcsn->bcls", cc, bc)      # (B, C, L, L)
    g = cb[:, None] * lmat                            # (B, H, C, L, L)
    y_diag = torch.matmul(g, xdt.permute(0, 3, 1, 2, 4)   # (B, H, C, L, P)
                          ).permute(0, 2, 3, 1, 4)    # (B, C, L, H, P)
    del lmat, g

    # chunk states
    decay_states = torch.exp(da_cum[..., -1:] - da_cum)      # (B, H, C, L)
    xw = xdt * decay_states.permute(0, 2, 3, 1)[..., None]   # (B, C, L, H, P)
    states = torch.einsum("bclhp,bcln->bchpn", xw, bc)       # (B, C, H, P, N)

    # inter-chunk recurrence, emitting the state before each chunk
    chunk_decay = torch.exp(da_cum[..., -1])                 # (B, H, C)
    s_prev = (torch.zeros((bsz, h, p, n), dtype=x.dtype, device=x.device)
              if s0 is None else s0)
    before = []
    for c in range(nc):
        before.append(s_prev)
        s_prev = s_prev * chunk_decay[:, :, c, None, None] + states[:, c]
    s_before = torch.stack(before, dim=1)                    # (B, C, H, P, N)

    # contribution of the carried-in state to each position
    state_decay = torch.exp(da_cum)                          # (B, H, C, L)
    y_off = torch.einsum("bcln,bchpn->bclhp", cc, s_before) \
        * state_decay.permute(0, 2, 3, 1)[..., None]

    y = (y_diag + y_off).reshape(bsz, nc * el, h, p)
    return y[:, :s], s_prev


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0)`` = max(x, 0) +
    log1p(exp(-|x|))."""
    return torch.clamp(x, min=0) + torch.log1p(torch.exp(-torch.abs(x)))


def mamba2(params: dict, u: torch.Tensor, cfg: ModelCfg, pol,
           state: dict | None = None, key=None, dense=None
           ) -> tuple[torch.Tensor, dict | None]:
    """u (B, S, d) -> (y, new_state).  ``state`` {"conv", "ssm"} (see
    `init_state`) turns on the decode carry: S > 1 prefills into it
    (chunked SSD seeded with it), S = 1 is the single-step recurrence;
    without it (training) the new state is None.  ``dense(p, h, j)``
    computes in_proj (j 0) and out_proj (j 1); None means
    ``common.dense(p, h, pol, fold_key(key, j))``."""
    di, nh, hp, ns, dc = dims(cfg)
    b, s, _ = u.shape
    if dense is None:
        def dense(p, h, j):
            return common.dense(p, h, pol, common.fold_key(key, j))
    f32 = torch.float32

    zxbcdt = dense(params["in_proj"], u, 0)
    z, xbc, dt_raw = torch.split(zxbcdt, [di, di + 2 * ns, nh], dim=-1)
    dt = softplus(dt_raw.to(f32) + params["dt_bias"].to(f32))
    a = -torch.exp(params["a_log"].to(f32))

    conv_state = state["conv"] if state is not None else None
    xbc_c, new_conv = _causal_conv(xbc, params["conv_w"], params["conv_b"],
                                   conv_state)
    xbc_c = silu(xbc_c)
    x, b_mat, c_mat = torch.split(xbc_c, [di, ns, ns], dim=-1)
    xh = x.reshape(b, s, nh, hp).to(f32)
    b_f = b_mat.to(f32)
    c_f = c_mat.to(f32)

    if state is None:
        y, _ = ssd_chunked(xh, dt, a, b_f, c_f, cfg.ssm.chunk)
        new_state = None
    elif s > 1:
        # prefill into a decode state: chunked SSD seeded with the carry
        y, s_final = ssd_chunked(xh, dt, a, b_f, c_f, cfg.ssm.chunk,
                                 s0=state["ssm"].to(f32))
        new_state = {"conv": new_conv,
                     "ssm": s_final.to(state["ssm"].dtype)}
    else:
        # single-step recurrence
        s_prev = state["ssm"].to(f32)                      # (B, H, P, N)
        dt1 = dt[:, 0]                                     # (B, H)
        dec = torch.exp(dt1 * a[None, :])                  # (B, H)
        xdt = xh[:, 0] * dt1[..., None]                    # (B, H, P)
        s_new = (s_prev * dec[..., None, None]
                 + xdt[..., None] * b_f[:, 0, None, None, :])
        y = torch.einsum("bhpn,bn->bhp", s_new, c_f[:, 0])[:, None]
        new_state = {"conv": new_conv, "ssm": s_new.to(state["ssm"].dtype)}

    y = y + params["d_skip"].to(f32)[None, None, :, None] * xh
    y = y.reshape(b, s, di).to(u.dtype)
    y = common.rmsnorm(params["norm"], y * silu(z), cfg.rms_eps)
    return dense(params["out_proj"], y, 1), new_state


def init_state(b: int, cfg: ModelCfg, dtype=torch.float32,
               device=None) -> dict:
    """The decode carry: the conv window (B, d_conv - 1, d_inner + 2
    d_state) and the SSM state (B, H, P, N), zeros."""
    di, nh, hp, ns, dc = dims(cfg)
    return {"conv": torch.zeros((b, dc - 1, di + 2 * ns), dtype=dtype,
                                device=device),
            "ssm": torch.zeros((b, nh, hp, ns), dtype=dtype, device=device)}
