"""Decode attention: kernel wrapper and its plain PyTorch version.

Replaces the Pallas TPU kernel `_kernel`
(src/repro/kernels/decode_gqa/decode_gqa.py:45, launched at :133 by
`_decode_gqa_call`).  The CUDA kernel is `csrc/decode_gqa.cu`; its header
says what bounds it on the H100 (the bytes of the live cache prefix) and
how its design answers that: the cache axis is split across blocks
(`split_plan`), each writing an unnormalised partial (acc, m, l) to an f32
workspace, and the partials are merged by the log-sum-exp rule in the
same launch.  `decode_gqa_split_plain` is that split-and-combine in plain
PyTorch, for the tests and for chip_smoke's check of the combine.

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
from repro_torch.kernels.attn_common import (NEG_INF, DTYPE_FLAG,
                                             check_float, check_index,
                                             softmax_rows)

launches = 0          # kernel launches since the last reset

KEY_TILE = 32         # keys per block per step of the split kernel
SMS = 132             # the H100's streaming multiprocessors
BLOCKS_PER_SM = 2     # blocks per SM the plan fills: one wave
MAX_SPLIT = 512       # the most splits the kernel's merge takes

_fn = None
_counters: dict = {}  # per device: int32 zeros, left zero by every launch


def _zeroed_counters(n: int, device) -> torch.Tensor:
    """The kernel's last-block counters: n int32 zeros on ``device``,
    allocated once (and again when a launch needs more)."""
    c = _counters.get(device)
    if c is None or c.numel() < n:
        c = _counters[device] = torch.zeros(max(n, 1024), dtype=torch.int32,
                                            device=device)
    return c


def _kernel():
    global _fn
    if _fn is None:
        lib = build.load("decode_gqa")
        if (lib.decode_gqa_key_tile(), lib.decode_gqa_max_split()) != (
                KEY_TILE, MAX_SPLIT):
            raise RuntimeError("decode_gqa: csrc key tile and split limit "
                               f"{lib.decode_gqa_key_tile()}, "
                               f"{lib.decode_gqa_max_split()} != "
                               f"{KEY_TILE}, {MAX_SPLIT}")
        fn = lib.decode_gqa_launch
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 \
            + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def split_plan(s: int, b: int, hkv: int) -> tuple[int, int]:
    """(n_split, chunk) of the split kernel for a cache of capacity ``s``:
    chunk is a multiple of KEY_TILE, n_split * chunk >= s, n_split <=
    MAX_SPLIT, and the grid of b * hkv * n_split blocks fills the card's
    BLOCKS_PER_SM * SMS block slots in one wave (a partly filled second
    wave would double the time of a cache-streaming grid).  From the shapes
    alone, so one plan serves a whole decode loop."""
    tiles = max(1, -(-s // KEY_TILE))
    want = min(MAX_SPLIT, BLOCKS_PER_SM * SMS // max(1, b * hkv))
    n_split = max(1, min(tiles, want))
    chunk = -(-tiles // n_split) * KEY_TILE
    return -(-max(s, 1) // chunk), chunk


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
    _check(q, k, v, length)
    if q.device.type == "cpu":
        return decode_gqa_plain(q, k, v, length)
    if q.device.type != "cuda":
        raise ValueError(f"decode_gqa runs on cuda or cpu, not {q.device}")
    return _launch(q, k, v, length)[0]


def _launch(q, k, v, length):
    """The launch on CUDA tensors; returns (out, workspace)."""
    global launches
    b, hq, d = q.shape
    s, hkv = k.shape[1], k.shape[2]
    if d > 128 or d % 8:
        raise ValueError(f"decode_gqa kernel needs D % 8 == 0 and D <= 128,"
                         f" got D={d}")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("decode_gqa kernel wants 16-byte aligned operands")
    n_split, chunk = split_plan(s, b, hkv)
    ws = torch.empty((b, hq, n_split, d + 2), dtype=torch.float32,
                     device=q.device)
    counters = _zeroed_counters(b * hq, q.device)   # >= b * hkv * row groups
    out = torch.empty_like(q)
    if out.numel():
        rc = _kernel()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                       length.data_ptr(), ws.data_ptr(), counters.data_ptr(),
                       out.data_ptr(), b, s, hq, hkv, d, n_split, chunk,
                       d ** -0.5, DTYPE_FLAG[q.dtype], DTYPE_FLAG[k.dtype],
                       build.stream_ptr(q.device))
        build.check(rc, "decode_gqa")
        launches += 1
    return out, ws


def decode_gqa_partials(q, k, v, length):
    """The split kernel's partials on CUDA tensors, as (m, l, acc) of
    shapes (B, Hq, n_split), (B, Hq, n_split), (B, Hq, n_split, D): the
    workspace left by a kernel call (chip_smoke's check of the combine)."""
    _check(q, k, v, length)
    ws = _launch(q, k, v, length)[1]
    d = q.shape[2]
    return ws[..., d], ws[..., d + 1], ws[..., :d]


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


def split_partials_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         length: torch.Tensor, chunk: int):
    """The split kernel's partials in plain PyTorch, f32 math: for chunk i
    of the cache, m_i the largest live score, l_i the sum of
    exp(score - m_i) over its live keys and acc_i the same weights times v;
    an empty chunk has m = NEG_INF, l = 0, acc = 0.  Shapes as
    `decode_gqa_partials`."""
    b, hq, d = q.shape
    s, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    n = -(-max(s, 1) // chunk)
    pad = n * chunk - s
    kf = torch.nn.functional.pad(k.to(torch.float32), (0, 0, 0, 0, 0, pad))
    vf = torch.nn.functional.pad(v.to(torch.float32), (0, 0, 0, 0, 0, pad))
    qg = q.reshape(b, hkv, g, d).to(torch.float32) * (d ** -0.5)
    sc = torch.einsum("bkgd,bskd->bkgs", qg, kf).reshape(b, hkv, g, n, chunk)
    lens = torch.clamp(length.to(torch.int64), max=s)
    mask = (torch.arange(n * chunk, device=q.device)[None, :]
            < lens[:, None]).reshape(b, 1, 1, n, chunk)
    sc = torch.where(mask, sc, NEG_INF)
    m = sc.amax(-1)
    p = torch.where(mask, torch.exp(sc - m[..., None]), 0.0)
    acc = torch.einsum("bkgnc,bnckd->bkgnd", p,
                       vf.reshape(b, n, chunk, hkv, d))
    return (m.reshape(b, hq, n), p.sum(-1).reshape(b, hq, n),
            acc.reshape(b, hq, n, d))


def combine_plain(m: torch.Tensor, l: torch.Tensor,
                  acc: torch.Tensor) -> torch.Tensor:
    """The log-sum-exp merge of split partials (f32):
    sum_i e^(m_i - M) acc_i / max(sum_i e^(m_i - M) l_i, 1e-30)."""
    w = torch.exp(m - m.amax(-1, keepdim=True))
    return (w[..., None] * acc).sum(-2) / torch.clamp(
        (w * l).sum(-1), min=1e-30)[..., None]


def decode_gqa_split_plain(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, length: torch.Tensor,
                           chunk: int) -> torch.Tensor:
    """The kernel's split-and-combine in plain PyTorch: per-chunk partials,
    then `combine_plain`; output in q's dtype."""
    return combine_plain(*split_partials_plain(q, k, v, length, chunk)) \
        .to(q.dtype)
