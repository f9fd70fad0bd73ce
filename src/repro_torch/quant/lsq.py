"""Learned Step Size Quantization (LSQ), forward only (port of
`repro/quant/lsq.py`).

  v_bar = clip(round(v / s), Qn, Qp);   v_hat = v_bar * s

``round`` is half-to-even in both frameworks (`torch.round`, `jnp.round`).
The division runs in the operands' dtype, as in the reference: after the
serve steps cast the parameters to bf16, ``v / s`` is a bf16 division, and
the codes are bit-exact with the reference only if the port divides in bf16
too.  The LSQ gradient rules (`_lsq_core_bwd`) come with the training slice.
"""
from __future__ import annotations

import torch


def qrange(bits: int, signed: bool) -> tuple[int, int]:
    if signed:
        return -(2 ** (bits - 1)), 2 ** (bits - 1) - 1
    return 0, 2 ** bits - 1


def _scaled_round(v: torch.Tensor, s, qn: int, qp: int) -> tuple:
    s_ = torch.clamp(torch.as_tensor(s, device=v.device), min=1e-8)
    v_bar = torch.round(v / s_)
    v_bar.clamp_(qn, qp)
    return v_bar, s_


def lsq_fake_quant(v: torch.Tensor, s, bits: int,
                   signed: bool) -> torch.Tensor:
    """Forward of the reference's LSQ fake-quant: clip(round(v/s)) * s."""
    qn, qp = qrange(bits, signed)
    v_bar, s_ = _scaled_round(v, s, qn, qp)
    return v_bar * s_


def lsq_quantize_int(v: torch.Tensor, s, bits: int,
                     signed: bool) -> torch.Tensor:
    """Integer codes (int32), no dequantization."""
    qn, qp = qrange(bits, signed)
    v_bar, _ = _scaled_round(v, s, qn, qp)
    return v_bar.to(torch.int32)


def init_step_size(v: torch.Tensor, bits: int, signed: bool) -> torch.Tensor:
    """LSQ init: s = 2 * mean(|v|) / sqrt(Qp)."""
    _, qp = qrange(bits, signed)
    return 2.0 * torch.mean(torch.abs(v)) / torch.sqrt(
        torch.tensor(float(qp), dtype=torch.float32, device=v.device))
