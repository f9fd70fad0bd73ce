"""Exact bit-serial decomposition for the 1-by-B TD operating mode (port of
`repro/quant/bitserial.py`).

Signed codes use offset encoding v' = v + 2^(B-1), and

    sum_k x_k w_k = sum_k x'_k w'_k - ox * sum_k w'_k - ow * sum_k x'_k
                    + K * ox * ow

Bit planes of x' are processed LSB first; plane b is weighted by 2^b.
"""
from __future__ import annotations

import torch


def to_offset(v_int: torch.Tensor, bits: int) -> torch.Tensor:
    """Signed int in [-2^(B-1), 2^(B-1)-1] -> unsigned in [0, 2^B - 1]."""
    return v_int + 2 ** (bits - 1)


def offset_of(bits: int) -> int:
    return 2 ** (bits - 1)


def bit_planes(v_uint: torch.Tensor, bits: int) -> torch.Tensor:
    """(bits, *v.shape) binary planes, LSB first.  v must be in [0, 2^B)."""
    shifts = torch.arange(bits, dtype=v_uint.dtype, device=v_uint.device)
    return (v_uint[None, ...] >> shifts.reshape((-1,) + (1,) * v_uint.ndim)) & 1


def recompose_planes(plane_results: torch.Tensor) -> torch.Tensor:
    """Weight plane b (leading axis, LSB first) by 2^b and sum."""
    bits = plane_results.shape[0]
    w = (2.0 ** torch.arange(bits, device=plane_results.device)).reshape(
        (bits,) + (1,) * (plane_results.ndim - 1))
    return (plane_results * w).sum(0)


def signed_matmul_via_offset(x_int: torch.Tensor, w_int: torch.Tensor,
                             bits_a: int, bits_w: int) -> torch.Tensor:
    """Exact signed int matmul via offset encoding + corrections (f32)."""
    ox, ow = offset_of(bits_a), offset_of(bits_w)
    xu = to_offset(x_int, bits_a).to(torch.float32)
    wu = to_offset(w_int, bits_w).to(torch.float32)
    k = x_int.shape[-1]
    main = xu @ wu
    corr_w = ox * wu.sum(0)
    corr_x = ow * xu.sum(-1, keepdim=True)
    return main - corr_w - corr_x + k * ox * ow
