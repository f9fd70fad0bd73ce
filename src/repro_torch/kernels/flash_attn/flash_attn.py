"""Flash-attention forward: kernel wrapper and its plain PyTorch version.

Replaces the Pallas TPU kernel `_kernel`
(src/repro/kernels/flash_attn/flash_attn.py:55, launched at :174 by
`_flash_attn_call`).  The CUDA kernel is `csrc/flash_attn.cu` (with
`csrc/attn_common.cuh` for its f32 paths); its header says what bounds
it on the H100 and how its design answers that.  `flash_plan` decides on
the host whether two blocks share each query tile's keys (when the query
tiles alone would leave SMs idle).

``flash_attn(q, k, v, kv_len, q_offset, causal=True)``: q (B, Sq, Hq, D),
k/v (B, Skv, Hkv, D) in float32 or bfloat16, ``kv_len`` (B,) int32 valid
key prefix (clamped to Skv) and ``q_offset`` (1,) int32 absolute position
of query row 0, both tensors on q's device (runtime operands, read by the
kernel from device memory).  Returns (B, Sq, Hq, D) in q's dtype.  CPU
tensors run `flash_attn_plain`; CUDA tensors launch the kernel or raise.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.attn_common import (DTYPE_FLAG, attn_mask,
                                             check_float, check_index,
                                             softmax_rows)

launches = 0          # kernel launches since the last reset

SMS = 132             # the H100's streaming multiprocessors

_fn = None


def _kernel():
    global _fn
    if _fn is None:
        fn = build.load("flash_attn").flash_attn_launch
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 \
            + [ctypes.c_float] + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def flash_plan(b: int, sq: int, hq: int, hkv: int) -> int:
    """Blocks sharing each 64-row query tile's key tiles on the
    tensor-core path: 2 (a thread block cluster) when the query tiles alone
    would leave SMs idle, else 1."""
    g = hq // hkv
    if g > 64:
        raise ValueError(f"flash_attn kernel needs Hq/Hkv <= 64, got {g}")
    return 2 if b * hkv * -(-sq // (64 // g)) < SMS else 1


def _check(q, k, v, kv_len, q_offset):
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attn wants q (B,Sq,Hq,D), k/v (B,Skv,Hkv,D);"
                         f" got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, _, hq, d = q.shape
    if k.shape[0] != b or k.shape[3] != d or hq % k.shape[2]:
        raise ValueError(f"flash_attn shape mismatch: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}")
    if k.dtype != v.dtype:
        raise TypeError(f"flash_attn: k is {k.dtype}, v is {v.dtype}")
    check_float("flash_attn", q, k, v)
    if k.device != q.device or v.device != q.device:
        raise ValueError("flash_attn operands on several devices")
    check_index("flash_attn kv_len", kv_len, b, q.device)
    check_index("flash_attn q_offset", q_offset, 1, q.device)


def flash_attn(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               kv_len: torch.Tensor, q_offset: torch.Tensor, *,
               causal: bool = True) -> torch.Tensor:
    """Fused GQA attention forward (see the module docstring)."""
    global launches
    _check(q, k, v, kv_len, q_offset)
    if q.device.type == "cpu":
        return flash_attn_plain(q, k, v, kv_len, q_offset, causal=causal)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attn runs on cuda or cpu, not {q.device}")
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    if d > 128:
        raise ValueError(f"flash_attn kernel needs D <= 128, got D={d}")
    kv_split = flash_plan(b, sq, hq, hkv)        # raises past g = 64
    if not (q.dtype == k.dtype == torch.bfloat16 and d == 128):
        kv_split = 1                              # the CUDA-core path
    out = torch.empty_like(q)
    if any(t.data_ptr() % 16 for t in (q, k, v, out)):
        raise ValueError("flash_attn kernel wants 16-byte aligned operands")
    if out.numel():
        rc = _kernel()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                       kv_len.data_ptr(), q_offset.data_ptr(),
                       out.data_ptr(), b, sq, skv, hq, hkv, d, int(causal),
                       d ** -0.5, DTYPE_FLAG[q.dtype], DTYPE_FLAG[k.dtype],
                       kv_split, build.stream_ptr(q.device))
        build.check(rc, "flash_attn")
        launches += 1
    return out


def flash_attn_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     kv_len: torch.Tensor, q_offset: torch.Tensor, *,
                     causal: bool = True) -> torch.Tensor:
    """The kernel's function in plain PyTorch, f32 math, scores
    materialized."""
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    qg = q.reshape(b, sq, hkv, g, d).to(torch.float32) * (d ** -0.5)
    sc = torch.einsum("bskgd,btkd->bkgst", qg, k.to(torch.float32))
    mask = attn_mask(kv_len, q_offset, sq, skv, causal)[:, None, None]
    o = softmax_rows(sc, mask, lambda p: torch.einsum(
        "bkgst,btkd->bkgsd", p, v.to(torch.float32)))
    return o.permute(0, 3, 1, 2, 4).reshape(b, sq, hq, d).to(q.dtype)
