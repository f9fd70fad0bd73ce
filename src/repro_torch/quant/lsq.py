"""Learned Step Size Quantization (LSQ) (port of `repro/quant/lsq.py`).

  v_bar = clip(round(v / s), Qn, Qp);   v_hat = v_bar * s

``round`` is half-to-even in both frameworks (`torch.round`, `jnp.round`).
The division runs in the operands' result dtype, as in the reference:
after the steps cast the parameters to bf16, ``v / s`` is a bf16 division,
and the codes are bit-exact with the reference only if the port divides in
bf16 too.  v and s are promoted as JAX promotes ``v / s_`` (a 0-d tensor
counts as strongly typed there, unlike PyTorch's own rule; a Python float
is weak and takes v's dtype).

`lsq_fake_quant` is an autograd Function with the reference's gradient
rules (`_lsq_core_bwd`): straight-through on round, exact elsewhere,
  d v_hat / d v = 1                   if Qn <= v/s <= Qp else 0
  d v_hat / d s = -v/s + round(v/s)   in range;  clipped bound outside
with the LSQ gradient scale 1 / sqrt(numel * Qp) on ds.  Its forward is
the `lsq_quant` kernel (CUDA tensors) or its plain version (CPU tensors).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import sharded
from repro_torch.kernels.lsq_quant.lsq_quant import lsq_quant
from repro_torch.roofline import counter


def qrange(bits: int, signed: bool) -> tuple[int, int]:
    if signed:
        return -(2 ** (bits - 1)), 2 ** (bits - 1) - 1
    return 0, 2 ** bits - 1


def _promote(v: torch.Tensor, s) -> tuple[torch.Tensor, torch.Tensor]:
    """(v, s) in the dtype of the reference's ``v / s``."""
    if not isinstance(s, torch.Tensor):
        s = torch.tensor(s, dtype=v.dtype, device=v.device)
    dt = torch.promote_types(v.dtype, s.dtype)
    return v.to(dt), s.to(device=v.device, dtype=dt)


def _scaled_round(v: torch.Tensor, s, qn: int, qp: int) -> tuple:
    """(vs, v_bar, s_): the forward's intermediates, rounded as the
    reference's ``_lsq_core_fwd`` rounds them (v and s already promoted)."""
    s_ = torch.clamp(s, min=1e-8)
    vs = v / s_
    return vs, torch.clamp(torch.round(vs), qn, qp), s_


def _fake_quant(v: torch.Tensor, s, qn: int, qp: int) -> torch.Tensor:
    """The lsq_quant kernel: on a DTensor elementwise on v's own shards
    (s replicated); under a `roofline.counter.Counter` recorded (about
    five operations an element, v read and the result written once) and
    not run."""
    if sharded.mesh_of(v, s) is not None:
        nd = v.dim()
        options = [(((d, None)), (d,)) for d in range(nd)]
        return sharded.local_call(
            lambda a, b: _fake_quant(a, b, qn, qp), [v, s], options)
    c = counter.active()
    if c is not None:
        c.record_kernel("lsq_quant", flops=5.0 * v.numel(),
                        nbytes=2.0 * v.numel() * v.element_size())
        return torch.empty_like(v)
    return lsq_quant(v, s, qn, qp)


class _LSQFakeQuant(torch.autograd.Function):
    """Saves v and s and recomputes v/s and its codes in the backward: for
    the lm_head weight of qwen3-8b that saves 2.5 GB of bf16 residuals."""

    @staticmethod
    def forward(ctx, v, s, qn, qp, lanes):
        ctx.save_for_backward(v, s)
        ctx.qrange = (qn, qp)
        ctx.lanes = lanes
        return _fake_quant(v, s, qn, qp)

    @staticmethod
    def backward(ctx, g):
        v, s = ctx.saved_tensors
        qn, qp = ctx.qrange
        vs, v_bar, _ = _scaled_round(v, s, qn, qp)
        in_range = (vs >= qn) & (vs <= qp)
        dv = torch.where(in_range, g, 0.0)
        ds_elem = torch.where(in_range, v_bar - vs, v_bar)
        # the reference computes the scale in float32 and applies it in the
        # operands' dtype (a weakly typed scalar); under its vmap each lane
        # is scaled by its own size, and the lanes' steps are summed
        lanes = ctx.lanes
        scale = np.float32(1.0) / np.sqrt(np.float32(vs.numel() // lanes)
                                          * np.float32(max(qp, 1.0)))
        scale = torch.tensor(float(scale)).to(vs.dtype).item()
        if lanes == 1:
            ds = (ds_elem * g).sum() * scale
        else:
            ds = ((ds_elem * g).reshape(lanes, -1).sum(1) * scale).sum()
        return dv, ds.expand(s.shape), None, None, None


def lsq_fake_quant(v: torch.Tensor, s, bits: int, signed: bool,
                   lanes: int = 1) -> torch.Tensor:
    """Differentiable LSQ fake-quant: clip(round(v/s)) * s, in the result
    dtype of v and s.  ``lanes`` > 1: v's leading dim holds that many
    lanes of the reference's ``jax.vmap`` over one shared s (the MoE's
    experts), each lane's step gradient scaled by its own element count."""
    qn, qp = qrange(bits, signed)
    v, s = _promote(v, s)
    return _LSQFakeQuant.apply(v, s, qn, qp, lanes)


def lsq_quantize_int(v: torch.Tensor, s, bits: int,
                     signed: bool) -> torch.Tensor:
    """Integer codes (int32), no dequantization; not differentiable."""
    qn, qp = qrange(bits, signed)
    _, v_bar, _ = _scaled_round(*_promote(v, s), qn, qp)
    return v_bar.to(torch.int32)


def init_step_size(v: torch.Tensor, bits: int, signed: bool) -> torch.Tensor:
    """LSQ init: s = 2 * mean(|v|) / sqrt(Qp)."""
    _, qp = qrange(bits, signed)
    return 2.0 * torch.mean(torch.abs(v)) / torch.sqrt(
        torch.tensor(float(qp), dtype=torch.float32, device=v.device))
