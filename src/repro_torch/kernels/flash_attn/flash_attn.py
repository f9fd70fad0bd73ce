"""Flash-attention forward: kernel wrapper and its plain PyTorch version.

Replaces the Pallas TPU kernel `_kernel`
(src/repro/kernels/flash_attn/flash_attn.py:55, launched at :174 by
`_flash_attn_call`).  The CUDA kernel is `csrc/flash_attn.cu`; its
header says what bounds each route on the H100 and how its design answers
that.  Routes:

* bf16 q with a bf16 cache at D 64 or 128: the tensor cores (wgmma).
  `flash_plan` decides on the host how many blocks (1, 2, 4 or 8, a
  thread block cluster) share each query tile's key tiles, when the query
  tiles alone would leave SMs idle; `flash_attn_split_plain` is that
  split and its merge in plain PyTorch.
* f32 q, an f32 cache (bf16 q against one too) or another head dim: the
  CUDA cores, in f32, one block a query tile of 64 rows over 32-key
  tiles, register-tiled.

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
from repro_torch.kernels.attn_common import (DTYPE_FLAG, NEG_INF,
                                             attn_mask, check_float,
                                             check_index, softmax_rows)

launches = 0          # kernel launches since the last reset

SMS = 132             # the H100's streaming multiprocessors
KEY_TILE = 64         # keys a tensor-core block multiplies at a time
MAX_SPLIT = 8         # the portable thread block cluster size
# blocks a key split aims for: a D 64 block leaves room for four on an SM
SPLIT_TARGET = 4 * SMS
TC_HEAD_DIMS = (64, 128)

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


def tensor_core_route(q: torch.Tensor, k: torch.Tensor) -> bool:
    """Whether the kernel takes its tensor-core route for these operands."""
    return (q.dtype == k.dtype == torch.bfloat16
            and q.shape[-1] in TC_HEAD_DIMS)


def flash_plan(b: int, sq: int, hq: int, hkv: int,
               skv: int | None = None) -> int:
    """Blocks sharing each 64-row query tile's key tiles on the
    tensor-core route: 1 when the query tiles alone give a block to every
    SM; else the least power of two, at most MAX_SPLIT and at most the
    ``skv`` keys' tiles (``skv`` None: Sq's), at which the blocks reach
    SPLIT_TARGET."""
    g = hq // hkv
    if g > 64:
        raise ValueError(f"flash_attn kernel needs Hq/Hkv <= 64, got {g}")
    blocks = b * hkv * -(-sq // (64 // g))
    if blocks >= SMS:
        return 1
    key_tiles = -(-(sq if skv is None else skv) // KEY_TILE)
    split = 1
    while (split < MAX_SPLIT and 2 * split <= key_tiles
           and blocks * split < SPLIT_TARGET):
        split *= 2
    return split


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
               causal: bool = True, kv_split: int | None = None
               ) -> torch.Tensor:
    """Fused GQA attention forward (see the module docstring).
    ``kv_split`` forces the tensor-core route's key split (1, 2, 4 or 8;
    None: `flash_plan`'s)."""
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
    plan = flash_plan(b, sq, hq, hkv, skv)        # raises past g = 64
    if kv_split is None:
        kv_split = plan if tensor_core_route(q, k) else 1
    elif kv_split not in (1, 2, 4, MAX_SPLIT) or (
            kv_split > 1 and not tensor_core_route(q, k)):
        raise ValueError(f"flash_attn: no key split {kv_split} for q "
                         f"{q.dtype}, k {k.dtype}, D={d}")
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


def flash_attn_split_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           kv_len: torch.Tensor, q_offset: torch.Tensor, *,
                           causal: bool = True,
                           kv_split: int = 1) -> torch.Tensor:
    """The tensor-core route's key split in plain PyTorch, f32 math: part
    p of ``kv_split`` takes key tiles p, p + kv_split, ... (KEY_TILE keys
    each) and keeps its own masked (m, l, acc); the parts merge as the
    kernel's cluster does, part r + step into part r at step 1, 2, 4, ...
    (the kernel takes 1, 2, 4 or 8 parts; this any count); the output is
    acc / max(l, 1e-30) in q's dtype."""
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    qg = q.reshape(b, sq, hkv, g, d).to(torch.float32) * (d ** -0.5)
    sc = torch.einsum("bskgd,btkd->bkgst", qg, k.to(torch.float32))
    mask = attn_mask(kv_len, q_offset, sq, skv, causal)[:, None, None]
    part_of = torch.arange(skv, device=q.device) // KEY_TILE % kv_split
    parts = []
    for p in range(kv_split):
        live = mask & (part_of == p)
        s = torch.where(live, sc, NEG_INF)
        m = s.amax(-1, keepdim=True)
        e = torch.where(live, torch.exp(s - m), 0.0)
        parts.append((m, e.sum(-1, keepdim=True), torch.einsum(
            "bkgst,btkd->bkgsd", e, v.to(torch.float32))))
    step = 1
    while step < kv_split:
        for r in range(0, kv_split - step, 2 * step):
            (m0, l0, a0), (m1, l1, a1) = parts[r], parts[r + step]
            mm = torch.maximum(m0, m1)
            w0, w1 = torch.exp(m0 - mm), torch.exp(m1 - mm)
            parts[r] = (mm, w0 * l0 + w1 * l1, w0 * a0 + w1 * a1)
        step *= 2
    _, l, acc = parts[0]
    o = acc / torch.clamp(l, min=1e-30)
    return o.permute(0, 3, 1, 2, 4).reshape(b, sq, hq, d).to(q.dtype)
