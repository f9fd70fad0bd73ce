"""Float32 arithmetic of the design-space engine that gives the same bits on
the CPU and on the card.

The engine's integer decisions (the redundancy R, the TDC coarsening q,
L_osc and the winning domain) sit on float32 threshold tests and argmins,
so one ulp between two devices can flip a decision that sits on a tie.
Addition, multiplication and division round correctly on both, but
torch's float32 ``sqrt``, ``pow``, ``log`` and ``exp`` on the CPU and on
CUDA are different approximations, and a library reduction sums in an
order of its own.  So:

* the transcendental functions here compute in float64 and round once to
  float32 (both devices' float64 results round to the same float32 but
  for a 1e-9 share of inputs); ``sqrt`` is then correctly rounded, as the
  reference's is;
* `fsum` and `fprod` reduce in one fixed order, by elementwise adds over
  slices: sequentially up to 32 terms and in sequential blocks of 32
  beyond, the order the reference's row reductions take on the CPU.

A python float exponent or base is rounded to float32 first, as the
reference's weakly typed scalars are.
"""
from __future__ import annotations

import numpy as np
import torch


def _f32(v: float) -> float:
    return float(np.float32(v))


def sqrt(x: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(x.double()).float()


def pow(x, y) -> torch.Tensor:
    """``x ** y`` with either side a tensor and the other a python float."""
    if isinstance(x, torch.Tensor):
        y = y.double() if isinstance(y, torch.Tensor) else _f32(y)
        return torch.pow(x.double(), y).float()
    return torch.pow(_f32(x), y.double()).float()


def log2(x: torch.Tensor) -> torch.Tensor:
    return torch.log2(x.double()).float()


def log10(x: torch.Tensor) -> torch.Tensor:
    return torch.log10(x.double()).float()


def _seq(x: torch.Tensor, op) -> torch.Tensor:
    acc = x[..., 0]
    for i in range(1, x.shape[-1]):
        acc = op(acc, x[..., i])
    return acc


def _ordered(x: torch.Tensor, dims, op) -> torch.Tensor:
    dims = (dims,) if isinstance(dims, int) else tuple(dims)
    nd = x.ndim
    dims = sorted(d % nd for d in dims)
    keep = [d for d in range(nd) if d not in dims]
    x = x.permute(*keep, *dims)
    x = x.reshape(*x.shape[:len(keep)], -1)
    n = x.shape[-1]
    if n <= 32 or n % 32:
        return _seq(x, op)
    return _seq(_seq(x.reshape(*x.shape[:-1], n // 32, 32), op), op)


def fsum(x: torch.Tensor, dims=-1) -> torch.Tensor:
    """Sum over ``dims`` (taken together, row-major) in the fixed order."""
    return _ordered(x, dims, torch.add)


def fprod(x: torch.Tensor, dims=-1) -> torch.Tensor:
    """Product over ``dims`` in the fixed order."""
    return _ordered(x, dims, torch.mul)


def fmean(x: torch.Tensor) -> torch.Tensor:
    """Mean of every entry (`fsum` over all of them, then one division)."""
    return fsum(x, tuple(range(x.ndim))) / x.numel()
