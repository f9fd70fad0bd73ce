"""Decode attention: kernel wrapper and its plain PyTorch version.

Replaces the Pallas TPU kernel `_kernel`
(src/repro/kernels/decode_gqa/decode_gqa.py:45, launched at :133 by
`_decode_gqa_call`).  The CUDA kernel is `csrc/decode_gqa.cu` (with
`csrc/attn_common.cuh`); its header says what bounds it on the H100 (the
bytes of the live cache prefix) and how its design answers that.

``decode_gqa(q, k, v, length)``: q (B, Hq, D) against the cache k/v
(B, S, Hkv, D), float32 or bfloat16; ``length`` (B,) int32 fill level on
q's device, clamped to S (a runtime operand read by the kernel from device
memory).  Returns (B, Hq, D) in q's dtype; a row with length 0 is 0.  CPU
tensors run `decode_gqa_plain`; CUDA tensors launch the kernel or raise.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.attn_common import (DTYPE_FLAG, check_float,
                                             check_index, softmax_rows)

launches = 0          # kernel launches since the last reset

_fn = None


def _kernel():
    global _fn
    if _fn is None:
        fn = build.load("decode_gqa").decode_gqa_launch
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 \
            + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _check(q, k, v, length):
    if q.dim() != 3 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"decode_gqa wants q (B,Hq,D), k/v (B,S,Hkv,D); got"
                         f" {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, hq, d = q.shape
    if k.shape[0] != b or k.shape[3] != d or hq % k.shape[2]:
        raise ValueError(f"decode_gqa shape mismatch: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}")
    if k.dtype != v.dtype:
        raise TypeError(f"decode_gqa: k is {k.dtype}, v is {v.dtype}")
    check_float("decode_gqa", q, k, v)
    if k.device != q.device or v.device != q.device:
        raise ValueError("decode_gqa operands on several devices")
    check_index("decode_gqa length", length, b, q.device)


def decode_gqa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               length: torch.Tensor) -> torch.Tensor:
    """Flash-decode of one query row per batch row (module docstring)."""
    global launches
    _check(q, k, v, length)
    if q.device.type == "cpu":
        return decode_gqa_plain(q, k, v, length)
    if q.device.type != "cuda":
        raise ValueError(f"decode_gqa runs on cuda or cpu, not {q.device}")
    b, hq, d = q.shape
    s, hkv = k.shape[1], k.shape[2]
    if d > 128 or hq // hkv > 64:
        raise ValueError(f"decode_gqa kernel needs D <= 128 and "
                         f"Hq/Hkv <= 64, got D={d}, g={hq // hkv}")
    out = torch.empty_like(q)
    if out.numel():
        rc = _kernel()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                       length.data_ptr(), out.data_ptr(), b, s, hq, hkv, d,
                       d ** -0.5, DTYPE_FLAG[q.dtype], DTYPE_FLAG[k.dtype],
                       build.stream_ptr(q.device))
        build.check(rc, "decode_gqa")
        launches += 1
    return out


def decode_gqa_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     length: torch.Tensor) -> torch.Tensor:
    """The kernel's function in plain PyTorch, f32 math."""
    b, hq, d = q.shape
    s, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    qg = q.reshape(b, hkv, g, d).to(torch.float32) * (d ** -0.5)
    sc = torch.einsum("bkgd,bskd->bkgs", qg, k.to(torch.float32))
    lens = torch.clamp(length.to(torch.int64), max=s)
    mask = (torch.arange(s, device=q.device)[None, :]
            < lens[:, None])[:, None, None, :]
    o = softmax_rows(sc, mask, lambda p: torch.einsum(
        "bkgs,bskd->bkgd", p, v.to(torch.float32)))
    return o.reshape(b, hq, d).to(q.dtype)
