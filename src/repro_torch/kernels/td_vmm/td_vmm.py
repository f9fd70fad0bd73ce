"""TD-VMM kernel wrapper and its plain PyTorch version.

Replaces the Pallas TPU kernel `_td_vmm_kernel`
(src/repro/kernels/td_vmm/td_vmm.py:110, launched at :229 by
`_td_vmm_call`).  The CUDA kernel is `csrc/td_vmm.cu`; its header says
what bounds it on the H100 (integer plane products, or at decode the bytes
of the int32 weight codes) and how its design answers that.

``td_vmm(x_int, w_int, params, seed, ...)`` takes signed codes x (M, K) and
w (K, N) int32, ``params`` = f32 [sigma_chain, tdc_q] and ``seed`` int64
(one uint32 value) as tensors on the same device, and returns (M, N)
float32.  ``params`` and ``seed`` stay runtime operands: the kernel reads
them from device memory.  Positions >= ``k_true`` are masked, so K need not
be padded.  On CPU tensors the wrapper runs `td_vmm_plain`; on CUDA tensors
it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.td_vmm.ref import MASK32, gauss_noise

launches = 0          # kernel launches since the last reset

_fn = None


def _kernel():
    global _fn
    if _fn is None:
        fn = build.load("td_vmm").td_vmm_launch
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _check(x, w, params, seed, bits_a, bits_w, k_true):
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"td_vmm wants x (M, K) and w (K, N), got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    if x.dtype != torch.int32 or w.dtype != torch.int32:
        raise TypeError(f"td_vmm wants int32 codes, got {x.dtype}, {w.dtype}")
    if params.dtype != torch.float32 or params.numel() != 2:
        raise TypeError("td_vmm params must be float32 [sigma, tdc_q]")
    if seed.dtype != torch.int64 or seed.numel() != 1:
        raise TypeError("td_vmm seed must be one int64 value")
    if not 1 <= bits_a <= 8 or not 1 <= bits_w <= 8:
        raise ValueError(f"bits_a, bits_w must be in 1..8, got "
                         f"{bits_a}, {bits_w}")
    if not 0 <= k_true <= x.shape[1]:
        raise ValueError(f"k_true={k_true} outside [0, {x.shape[1]}]")
    devs = {t.device for t in (x, w, params, seed)}
    if len(devs) != 1:
        raise ValueError(f"td_vmm operands on several devices: {devs}")


def td_vmm(x_int: torch.Tensor, w_int: torch.Tensor, params: torch.Tensor,
           seed: torch.Tensor, *, bits_a: int, bits_w: int, n_chain: int,
           k_true: int | None = None) -> torch.Tensor:
    """Noisy bit-serial TD product of signed codes, (M, N) float32."""
    global launches
    if k_true is None:
        k_true = x_int.shape[1]
    _check(x_int, w_int, params, seed, bits_a, bits_w, k_true)
    if x_int.device.type == "cpu":
        return td_vmm_plain(x_int, w_int, params, seed, bits_a=bits_a,
                            bits_w=bits_w, n_chain=n_chain, k_true=k_true)
    if x_int.device.type != "cuda":
        raise ValueError(f"td_vmm runs on cuda or cpu, not {x_int.device}")
    x = x_int.contiguous()
    w = w_int.contiguous()
    m, k = x.shape
    n = w.shape[1]
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    if m and n:
        rc = _kernel()(x.data_ptr(), w.data_ptr(), params.data_ptr(),
                       seed.data_ptr(), out.data_ptr(), m, n, k, n_chain,
                       k_true, bits_a, bits_w, build.stream_ptr(x.device))
        build.check(rc, "td_vmm")
        launches += 1
    return out


def td_vmm_plain(x_int: torch.Tensor, w_int: torch.Tensor,
                 params: torch.Tensor, seed: torch.Tensor, *, bits_a: int,
                 bits_w: int, n_chain: int,
                 k_true: int | None = None) -> torch.Tensor:
    """The kernel's function in plain PyTorch, with the Pallas kernel's
    order of float operations (per segment: 2^b-weighted planes summed
    LSB first, then ``out += acc - side_sums``), so that at sigma = 0 it is
    bit-exact with both kernels."""
    m, k = x_int.shape
    n = w_int.shape[1]
    if k_true is None:
        k_true = k
    dev = x_int.device
    ox, ow = 2 ** (bits_a - 1), 2 ** (bits_w - 1)
    n_seg = max(1, -(-k // n_chain))
    k_pad = n_seg * n_chain
    live = torch.arange(k_pad, device=dev) < k_true
    xu = torch.where(live, torch.nn.functional.pad(x_int, (0, k_pad - k))
                     + ox, 0).reshape(m, n_seg, n_chain)
    wu = torch.where(live[:, None],
                     torch.nn.functional.pad(w_int, (0, 0, 0, k_pad - k))
                     + ow, 0).reshape(n_seg, n_chain, n)
    sigma = params[0]
    q = torch.clamp(params[1], min=1.0)
    s_f = torch.arange(n_seg, device=dev, dtype=torch.float32)
    n_live = torch.clamp(torch.clamp(float(k_true) - s_f * n_chain, min=1.0),
                         max=float(n_chain))
    sig_seg = (sigma * torch.sqrt(n_live / float(n_chain)))[None, :, None]
    wf = wu.to(torch.float32)
    seg_i = torch.arange(n_seg, dtype=torch.int64, device=dev)
    row_i = torch.arange(m, dtype=torch.int64, device=dev)
    col_i = torch.arange(n, dtype=torch.int64, device=dev)
    seed_v = seed.reshape(()).to(torch.int64)
    acc = torch.zeros((m, n_seg, n), dtype=torch.float32, device=dev)
    for b in range(bits_a):
        plane = ((xu >> b) & 1).to(torch.float32)
        partial = torch.einsum("msk,skn->msn", plane, wf)
        idx = (((b * n_seg + seg_i[None, :, None]) * m
                + row_i[:, None, None]) & MASK32) * n + col_i[None, None, :]
        partial = partial + sig_seg * gauss_noise(idx, seed_v)
        partial = q * torch.round(partial / q)
        acc = acc + float(2 ** b) * partial
    corr = float(ow) * xu.sum(-1).to(torch.float32)[:, :, None] \
        + float(ox) * wu.sum(1).to(torch.float32)[None, :, :]
    d = acc - corr
    out = torch.full((m, n), float(k_true * ox * ow), dtype=torch.float32,
                     device=dev)
    for s in range(n_seg):
        out = out + d[:, s]
    return out
