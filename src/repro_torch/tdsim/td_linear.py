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
"""
from __future__ import annotations

import torch

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
    if eps is not None:
        live = torch.clamp(k - torch.arange(n_seg) * pol.n_chain, min=1,
                           max=pol.n_chain).to(torch.float32)
        sig = float(pol.sigma_chain) * torch.sqrt(live / pol.n_chain)
        partial = partial + eps * sig[:, None]
    if pol.tdc_q > 1:
        partial = pol.tdc_q * torch.round(partial / pol.tdc_q)
    else:
        partial = torch.round(partial)
    per_plane = partial.sum(-2)
    main = bitserial.recompose_planes(per_plane)
    corr_w = ox * wu.sum(0)
    corr_x = ow * xu.to(torch.float32).sum(-1, keepdim=True)
    return main - corr_w - corr_x + k * ox * ow


def _fq_matmul(x, w, s_a, s_w, bits_a: int, bits_w: int):
    """Differentiable fake-quant LSQ matmul: the STE backward function and
    the forward of "quant" mode."""
    x_fq = lsq.lsq_fake_quant(x, s_a, bits_a, signed=True)
    w_fq = lsq.lsq_fake_quant(w, s_w, bits_w, signed=True)
    return x_fq @ w_fq


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
        return x @ w
    if pol.mode == "quant":
        return _fq_matmul(x, w, s_a, s_w, pol.bits_a, pol.bits_w)
    if pol.mode != "td":
        raise ValueError(f"unknown td mode {pol.mode!r}")
    seed = td_ref.derive_seed((0, 0) if key is None else key)
    return _TDMatmulSTE.apply(x, w, s_a, s_w, pol, seed)


def linear(params: dict, x: torch.Tensor, pol: TDPolicy,
           key=None) -> torch.Tensor:
    """Linear layer dispatching on the policy.  params holds 'w' (K, N),
    optional 'b' (N,), and when quantized 's_a', 's_w' scalars."""
    if pol.mode == "precise":
        y = x @ params["w"]
    else:
        y = td_matmul(x, params["w"], params["s_a"], params["s_w"], pol, key)
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
