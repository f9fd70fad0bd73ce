"""TD execution simulator: a matmul that computes y = x @ w the way the
paper's time-domain hardware would (port of `repro/tdsim/td_linear.py`).

Mode "td": LSQ-quantize x and w to signed codes, run the TD-VMM kernel
(offset encoding, bit-serial planes, per-chain noise, TDC rounding and the
side sums in one launch) and dequantize with s_a * s_w.  Like the
reference, every td matmul quantizes the full weight matrix on each call.
Gradients are straight-through (`_TDMatmulSTE`, the reference's
`_td_matmul_ste`): the backward is the gradient of the fake-quant LSQ
matmul `_fq_matmul`, recomputed there, so its two `lsq_fake_quant` calls
run the lsq_quant kernel in the backward only.  Mode "quant" is
`_fq_matmul` itself.

``key`` is a raw two-word uint32 PRNG key (`repro_torch.prng`); the noise
seed is ``derive_seed(key)``.  With ``key=None`` it is
``derive_seed((0, 0))``: the reference seeds every keyless TD matmul from
``PRNGKey(0)``, and the serve steps pass no key.

`td_matmul_lanes` / `linear_lanes` are the reference's ``jax.vmap`` of
``_td_matmul_ste`` over P lanes (the batched noise search's probes): each
lane its own x, sigma, tdc_q and seed over one w (or one w a lane), in one
td_vmm launch.  They are forward-only.  `td_matmul_experts` is the
MoE's ``jax.vmap`` of ``td_matmul`` over its experts (one w a lane), with
the lanes' STE backward (`_TDLanesSTE`).
"""
from __future__ import annotations

import torch

from repro_torch import prng
from repro_torch.kernels.td_vmm import ops as td_ops
from repro_torch.kernels.td_vmm import ref as td_ref
from repro_torch.quant import bitserial, lsq
from repro_torch.tdsim.policy import TDPolicy


def _segment(k: int, n_chain: int) -> tuple[int, int]:
    """(n_segments, padded_k)."""
    n_seg = max(1, -(-k // n_chain))
    return n_seg, n_seg * n_chain


def td_matmul_int(x_int: torch.Tensor, w_int: torch.Tensor, pol: TDPolicy,
                  eps: torch.Tensor | None = None) -> torch.Tensor:
    """Integer-domain TD matmul with materialized planes: the test oracle.

    x_int (..., K) and w_int (K, N) are signed codes.  The reference draws
    its noise from threefry; torch cannot reproduce that stream, so the
    caller passes ``eps`` of shape (bits_a, ..., n_seg, N) (standard
    normal), or None for no noise.
    """
    k, n_out = w_int.shape
    n_seg, k_pad = _segment(k, pol.n_chain)
    ox = bitserial.offset_of(pol.bits_a)
    ow = bitserial.offset_of(pol.bits_w)
    xu = bitserial.to_offset(x_int, pol.bits_a)
    wu = bitserial.to_offset(w_int, pol.bits_w).to(torch.float32)
    pad = k_pad - k
    xu_p = torch.nn.functional.pad(xu, (0, pad))
    wu_p = torch.nn.functional.pad(wu, (0, 0, 0, pad))
    xw_seg = wu_p.reshape(n_seg, pol.n_chain, n_out)
    planes = bitserial.bit_planes(xu_p, pol.bits_a)
    planes_seg = planes.reshape(planes.shape[:-1] + (n_seg, pol.n_chain)
                                ).to(torch.float32)
    partial = torch.einsum("b...sk,skn->b...sn", planes_seg, xw_seg)
    dev = partial.device
    if isinstance(pol.tdc_q, torch.Tensor):
        # a runtime operand (`models.common.runtime_td_policy`): as in the
        # kernel, q is clamped to at least 1 and never read on the host
        q = torch.clamp(pol.tdc_q.to(device=dev, dtype=torch.float32),
                        min=1.0)
    else:
        q = pol.tdc_q
    if eps is not None:
        live = torch.clamp(k - torch.arange(n_seg, device=dev) * pol.n_chain,
                           min=1, max=pol.n_chain).to(torch.float32)
        sigma = pol.sigma_chain
        sigma = (sigma.to(device=dev, dtype=torch.float32)
                 if isinstance(sigma, torch.Tensor) else float(sigma))
        # sigma 0 adds exactly 0
        partial = partial + eps * (sigma * torch.sqrt(live / pol.n_chain)
                                   )[:, None]
    if isinstance(q, torch.Tensor) or q > 1:
        partial = q * torch.round(partial / q)
    else:
        partial = torch.round(partial)
    per_plane = partial.sum(-2)
    main = bitserial.recompose_planes(per_plane)
    corr_w = ox * wu.sum(0)
    corr_x = ow * xu.to(torch.float32).sum(-1, keepdim=True)
    return main - corr_w - corr_x + k * ox * ow


def _matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` with the reference's promotion: operands of two float
    dtypes (float32 frame embeddings against bf16 weights) multiply in
    the wider one, as `jnp.matmul` does; torch's matmul refuses them."""
    if x.dtype != w.dtype:
        dt = torch.promote_types(x.dtype, w.dtype)
        x, w = x.to(dt), w.to(dt)
    return x @ w


def _fq_matmul(x, w, s_a, s_w, bits_a: int, bits_w: int, lanes: int = 1):
    """Differentiable fake-quant LSQ matmul: the STE backward function and
    the forward of "quant" mode.  ``lanes`` > 1: x (E, ..., K) and w
    (E, K, N) are E lanes sharing s_a and s_w (`td_matmul_experts`)."""
    x_fq = lsq.lsq_fake_quant(x, s_a, bits_a, signed=True, lanes=lanes)
    w_fq = lsq.lsq_fake_quant(w, s_w, bits_w, signed=True, lanes=lanes)
    return _matmul(x_fq, w_fq)


class _TDMatmulSTE(torch.autograd.Function):
    """Kernel forward, fake-quant backward.  Saves (x, w, s_a, s_w) and
    gives sigma, q and the seed (host values of ``pol`` and ``seed``) no
    gradient, as the reference's zero cotangents do."""

    @staticmethod
    def forward(ctx, x, w, s_a, s_w, pol: TDPolicy, seed: int):
        x_int = lsq.lsq_quantize_int(x, s_a, pol.bits_a, signed=True)
        w_int = lsq.lsq_quantize_int(w, s_w, pol.bits_w, signed=True)
        y_int = td_ops.td_vmm_seeded(x_int, w_int, pol, seed)
        y = y_int * (torch.clamp(s_a, min=1e-8) * torch.clamp(s_w, min=1e-8))
        ctx.save_for_backward(x, w, s_a, s_w)
        ctx.bits = (pol.bits_a, pol.bits_w)
        return y.to(torch.promote_types(x.dtype, w.dtype))

    @staticmethod
    def backward(ctx, g):
        saved = ctx.saved_tensors
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_() for t in saved]
            y = _fq_matmul(*leaves, *ctx.bits)
            grads = torch.autograd.grad(y, leaves, g.to(y.dtype))
        return (*grads, None, None)


def td_matmul(x: torch.Tensor, w: torch.Tensor, s_a, s_w, pol: TDPolicy,
              key=None) -> torch.Tensor:
    """TD-simulated matmul with LSQ scales and STE gradients.  x (..., K),
    w (K, N); ``key`` a raw two-word uint32 PRNG key, None meaning
    ``(0, 0)``."""
    if pol.mode == "precise":
        return _matmul(x, w)
    if pol.mode == "quant":
        return _fq_matmul(x, w, s_a, s_w, pol.bits_a, pol.bits_w)
    if pol.mode != "td":
        raise ValueError(f"unknown td mode {pol.mode!r}")
    seed = td_ref.derive_seed((0, 0) if key is None else key)
    return _TDMatmulSTE.apply(x, w, s_a, s_w, pol, seed)


def td_matmul_lanes(x: torch.Tensor, w: torch.Tensor, s_a, s_w,
                    pol: TDPolicy, sigma: torch.Tensor, tdc_q: torch.Tensor,
                    seeds: torch.Tensor) -> torch.Tensor:
    """P lanes of the td-mode matmul, forward only: x (P, ..., K), w (K, N)
    or (P, K, N), ``sigma`` and ``tdc_q`` (P,) and ``seeds`` (P,) int64
    (derived uint32 seeds) on x's device.  Quantizes and dequantizes as
    `_TDMatmulSTE.forward`, so lane p equals ``td_matmul`` of lane p's x at
    its sigma, tdc_q and seed bit for bit."""
    x_int = lsq.lsq_quantize_int(x, s_a, pol.bits_a, signed=True)
    return td_codes_lanes(x_int, w, s_a, s_w, pol, sigma, tdc_q, seeds,
                          torch.promote_types(x.dtype, w.dtype))


def td_codes_lanes(x_int: torch.Tensor, w: torch.Tensor, s_a, s_w,
                   pol: TDPolicy, sigma: torch.Tensor, tdc_q: torch.Tensor,
                   seeds: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """`td_matmul_lanes` from x's codes (``lsq_quantize_int(x, s_a)``),
    for a caller that frees x before the launch; ``dtype`` is the result's
    (that of x and w)."""
    if pol.mode != "td":
        raise ValueError(f"td_matmul_lanes runs td mode, not {pol.mode!r}")
    w_int = lsq.lsq_quantize_int(w, s_w, pol.bits_w, signed=True)
    y_int = td_ops.td_vmm_lanes(x_int, w_int, pol, sigma, tdc_q, seeds)
    y = y_int * (torch.clamp(s_a, min=1e-8) * torch.clamp(s_w, min=1e-8))
    return y.to(dtype)


class _TDLanesSTE(torch.autograd.Function):
    """`_TDMatmulSTE` over E lanes with one w a lane: the forward is one
    `td_matmul_lanes` launch, the backward the fake-quant gradient of every
    lane at once (`_fq_matmul` batched over the lanes, s_a and s_w shared,
    so their gradients sum over the lanes as under the reference's vmap).
    sigma, q and the seeds get no gradient."""

    @staticmethod
    def forward(ctx, x, w, s_a, s_w, pol: TDPolicy, sigma, tdc_q, seeds):
        ctx.save_for_backward(x, w, s_a, s_w)
        ctx.bits = (pol.bits_a, pol.bits_w)
        return td_matmul_lanes(x, w, s_a, s_w, pol, sigma, tdc_q, seeds)

    @staticmethod
    def backward(ctx, g):
        saved = ctx.saved_tensors
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_() for t in saved]
            y = _fq_matmul(*leaves, *ctx.bits, lanes=saved[1].shape[0])
            grads = torch.autograd.grad(y, leaves, g.to(y.dtype))
        return (*grads, None, None, None, None)


_seeds_memo: dict[tuple, torch.Tensor] = {}


def _lane_seeds(seeds: tuple, device) -> torch.Tensor:
    """The (E,) int64 device tensor of ``seeds``, memoized for the keyless
    calls of serving (every lane at ``derive_seed((0, 0))``).  Keyed seeds
    (training) change at every call; they go to the card by a
    non-blocking copy from pinned memory, as a plain copy from the host
    would wait for the device."""
    device = torch.device(device)
    key = (seeds, device)
    t = _seeds_memo.get(key)
    if t is None:
        t = torch.tensor(seeds, dtype=torch.int64)
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        else:
            t = t.to(device)
        if len(set(seeds)) == 1:
            _seeds_memo[key] = t
    return t


def td_matmul_experts(x: torch.Tensor, w: torch.Tensor, s_a, s_w,
                      pol: TDPolicy, key=None) -> torch.Tensor:
    """The MoE's expert matmul, the reference's ``jax.vmap`` of
    ``td_matmul`` over the E experts: x (E, C, K) @ w (E, K, N) ->
    (E, C, N), s_a and s_w one for the stack.  "precise" is the batched
    product; "quant" the batched `_fq_matmul`; "td" one td_vmm launch over
    the E lanes (w a lane, every lane at the policy's sigma and tdc_q),
    lane e seeded by ``derive_seed(split(key, E)[e])`` (``(0, 0)`` for
    every lane when ``key`` is None), with the lanes' STE backward."""
    e = w.shape[0]
    if pol.mode == "precise":
        return torch.matmul(x, w)
    if pol.mode == "quant":
        return _fq_matmul(x, w, s_a, s_w, pol.bits_a, pol.bits_w, lanes=e)
    if pol.mode != "td":
        raise ValueError(f"unknown td mode {pol.mode!r}")
    keys = [(0, 0)] * e if key is None else prng.split(key, e)
    seeds = _lane_seeds(tuple(td_ref.derive_seed(k) for k in keys),
                        x.device)
    ops = td_ops.policy_params(pol, x.device)
    return _TDLanesSTE.apply(x, w, s_a, s_w, pol, ops[0].expand(e),
                             ops[1].expand(e), seeds)


def linear(params: dict, x: torch.Tensor, pol: TDPolicy,
           key=None) -> torch.Tensor:
    """Linear layer dispatching on the policy.  params holds 'w' (K, N),
    optional 'b' (N,), and when quantized 's_a', 's_w' scalars."""
    if pol.mode == "precise":
        y = _matmul(x, params["w"])
    else:
        y = td_matmul(x, params["w"], params["s_a"], params["s_w"], pol, key)
    if "b" in params:
        y = y + params["b"]
    return y


def linear_lanes(params: dict, x: torch.Tensor, pol: TDPolicy,
                 sigma: torch.Tensor, tdc_q: torch.Tensor,
                 seeds: torch.Tensor) -> torch.Tensor:
    """`linear` over P lanes of x (P, ..., K), forward only: in td mode
    `td_matmul_lanes` with a (sigma, tdc_q, seed) a lane; the other modes
    have no noise, so they are `linear` of x as it is (``sigma``,
    ``tdc_q`` and ``seeds`` are not read)."""
    if pol.mode == "td":
        y = td_matmul_lanes(x, params["w"], params["s_a"], params["s_w"],
                            pol, sigma, tdc_q, seeds)
    else:
        y = td_matmul(x, params["w"], params.get("s_a"), params.get("s_w"),
                      pol)
    if "b" in params:
        y = y + params["b"]
    return y


def init_linear(gen: torch.Generator, k: int, n: int, pol: TDPolicy,
                bias: bool = False, dtype=torch.float32,
                scale: float | None = None, device=None) -> dict:
    """Init params for `linear` (same distributions as the reference:
    normal * std, s_w = 2 mean|w| / sqrt(Qp), s_a = 2 / sqrt(Qp)).  The
    weight is drawn in float32 and stored in ``dtype``, so a bf16 model is
    cast once here instead of on every step."""
    std = scale if scale is not None else (1.0 / (k ** 0.5))
    w = torch.randn((k, n), generator=gen, dtype=torch.float32,
                    device=device) * std
    p = {}
    if pol.mode != "precise":
        p["s_w"] = lsq.init_step_size(w, pol.bits_w, signed=True).to(dtype)
        p["s_a"] = torch.tensor(
            2.0 / (lsq.qrange(pol.bits_a, True)[1] ** 0.5),
            dtype=torch.float32, device=device).to(dtype)
    p["w"] = w.to(dtype)
    del w
    if bias:
        p["b"] = torch.zeros((n,), dtype=dtype, device=device)
    return p
