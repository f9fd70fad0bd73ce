"""LSQ fake-quant kernel wrapper.

Replaces the Pallas TPU kernel `_kernel`
(src/repro/kernels/lsq_quant/lsq_quant.py:14, launched at :29 by
`lsq_quant_pallas`).  The CUDA kernel is `csrc/lsq_quant.cu`; its header
says what bounds it on the H100 (bytes: one read and one write of x) and
how its design answers that.

``lsq_quant(x, s, qn, qp)``: x of any shape and s (one element) in the
same dtype, float32 or bfloat16, on one device; qn, qp the integer clip
range.  Returns ``clip(round(x / max(s, 1e-8)), qn, qp) * max(s, 1e-8)``
in x's dtype and shape.  ``s`` stays a runtime operand: the kernel reads
it from device memory.  CPU tensors run `ref.lsq_quant_ref`; CUDA tensors
launch the kernel or raise.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.lsq_quant.ref import lsq_quant_ref

launches = 0          # kernel launches since the last reset

DTYPE_FLAG = {torch.float32: 0, torch.bfloat16: 1}

_fn = None


def _kernel():
    global _fn
    if _fn is None:
        fn = build.load("lsq_quant").lsq_quant_launch
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong] \
            + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _check(x, s, qn, qp):
    if x.dtype not in DTYPE_FLAG:
        raise TypeError(f"lsq_quant takes float32 or bfloat16, got {x.dtype}")
    if s.dtype != x.dtype or s.numel() != 1:
        raise TypeError(f"lsq_quant wants one step size in x's dtype "
                        f"{x.dtype}, got {s.dtype} {tuple(s.shape)}")
    if s.device != x.device:
        raise ValueError(f"lsq_quant operands on {x.device} and {s.device}")
    if int(qn) != qn or int(qp) != qp or not qn <= qp:
        raise ValueError(f"lsq_quant wants an integer range qn <= qp, got "
                         f"{qn}, {qp}")


def lsq_quant(x: torch.Tensor, s: torch.Tensor, qn: float,
              qp: float) -> torch.Tensor:
    """Fused LSQ fake-quant of x (see the module docstring)."""
    global launches
    _check(x, s, qn, qp)
    if x.device.type == "cpu":
        return lsq_quant_ref(x, s, qn, qp)
    if x.device.type != "cuda":
        raise ValueError(f"lsq_quant runs on cuda or cpu, not {x.device}")
    xc = x.contiguous()
    out = torch.empty_like(xc)
    if out.numel():
        rc = _kernel()(xc.data_ptr(), s.data_ptr(), out.data_ptr(),
                       out.numel(), int(qn), int(qp), DTYPE_FLAG[x.dtype],
                       build.stream_ptr(x.device))
        build.check(rc, "lsq_quant")
        launches += 1
    return out
