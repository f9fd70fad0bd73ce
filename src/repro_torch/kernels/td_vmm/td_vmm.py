"""TD-VMM kernel wrapper, its route plan and its plain PyTorch versions.

Replaces the Pallas TPU kernel `_td_vmm_kernel`
(src/repro/kernels/td_vmm/td_vmm.py:110, launched at :229 by
`_td_vmm_call`).  The CUDA kernel is `csrc/td_vmm.cu`: the bit-plane
products run on the int8 tensor cores (mma.sync u8 x u8 -> s32), x and w
narrowed to u8 offset codes in registers from int32 shared-memory stages.
Its
header says what bounds each route on the H100 and how the design answers
it.  `td_vmm_plan` picks the route from the shapes alone:

* "block" (M > 8): a block owns a BM x 64 output tile and walks every
  segment in order (prefill, training), its two warpgroups a half each;
  the noise epilogue is its largest part when sigma > 0;
* "split" (M <= 8, decode): the grid also splits over segments, each block
  writing its segment's term to a scratch buffer (n_seg, M, N) that the
  last block of a column tile adds in segment order; bound by the bytes of
  w.  `td_vmm_split_plain` is that split and combine in plain PyTorch.

Either way a call is one launch, and the result is the same bit for bit.

``td_vmm(x_int, w_int, params, seed, ...)`` takes signed codes x (M, K) and
w (K, N) int32, ``params`` = f32 [sigma_chain, tdc_q] and ``seed`` int64
(one uint32 value) as tensors on the same device, and returns (M, N)
float32.  ``params`` and ``seed`` stay runtime operands: the kernel reads
them from device memory.  Positions >= ``k_true`` are masked, so K need not
be padded.  Codes must lie in their ranges (as `lsq_quantize_int` gives
them): the kernel narrows them to one byte.  On CPU tensors the wrapper
runs `td_vmm_plain`; on CUDA tensors it launches the kernel or raises.

The lane axis (the reference's kernel under ``jax.vmap``: a probe of the
batched noise search, a head of TD attention): x (P, M, K) with w (K, N)
shared by every lane, (P, K, N) one a lane, or (L, K, N) with L dividing P
(lane p reads w[p % L]: the MoE's P x E expert lanes under the search read
the E experts' codes with no copy a probe), ``params`` (P, 2) and ``seed``
(P,) return (P, M, N), still in one launch (lanes on the grid's z axis).
Every lane keeps its own noise index ((b*n_seg+seg)*M+row)*N+col over its
own M, so a lane equals a single-lane call with that lane's
operands bit for bit, noise included.  The route is planned from the
per-lane M.  The plain versions take lanes by looping the single-lane
function.
"""
from __future__ import annotations

import ctypes
import dataclasses

import torch

from repro_torch.kernels import build
from repro_torch.kernels.td_vmm.ref import MASK32, gauss_noise

launches = 0          # kernel launches since the last reset

SPLIT_MAX_M = 8       # rows of x the split route's plane tiles hold

_fn = None
_counters: dict = {}  # per device: int32 zeros, left zero by every launch


@dataclasses.dataclass(frozen=True)
class TdVmmPlan:
    """How one td_vmm call runs: ``route`` "block" (the segments walked
    inside a block) or "split" (one block a column tile and segment), over
    ``n_seg`` chain segments.  The tiles are the kernel's own."""
    route: str
    n_seg: int


def td_vmm_plan(m: int, k: int, n: int, n_chain: int,
                bits_a: int) -> TdVmmPlan:
    """The route of a call, from the shapes alone (so one plan serves every
    call of a shape).  Small M (decode) takes the split route: its scratch
    is n_seg * M * N floats, and its narrow side holds at most SPLIT_MAX_M
    rows of x."""
    n_seg = max(1, -(-k // n_chain))
    return TdVmmPlan("split" if m <= SPLIT_MAX_M else "block", n_seg)


def _kernel():
    global _fn
    if _fn is None:
        fn = build.load("td_vmm").td_vmm_launch
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 9 \
            + [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _zeroed_counters(n: int, device) -> torch.Tensor:
    """The split route's last-block counters: n int32 zeros on ``device``
    (one a column of w, more than its column tiles), allocated once and
    again when a launch needs more."""
    c = _counters.get(device)
    if c is None or c.numel() < n:
        c = _counters[device] = torch.zeros(max(n, 2048), dtype=torch.int32,
                                            device=device)
    return c


def _check(x, w, params, seed, bits_a, bits_w, k_true):
    lanes = x.shape[0] if x.dim() == 3 else 1
    if (x.dim() not in (2, 3) or w.dim() not in (2, x.dim())
            or x.shape[-1] != w.shape[-2]
            or (w.dim() == 3 and w.shape[0] != lanes
                and (w.shape[0] < 1 or lanes % w.shape[0]))):
        raise ValueError(f"td_vmm wants x (M, K) and w (K, N), or x (P, M, "
                         f"K) and w (K, N) or (L, K, N) with L dividing P, "
                         f"got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    if x.dtype != torch.int32 or w.dtype != torch.int32:
        raise TypeError(f"td_vmm wants int32 codes, got {x.dtype}, {w.dtype}")
    if params.dtype != torch.float32 or params.numel() != 2 * lanes:
        raise TypeError(f"td_vmm params must be float32 [sigma, tdc_q] for "
                        f"each of {lanes} lane(s)")
    if seed.dtype != torch.int64 or seed.numel() != lanes:
        raise TypeError(f"td_vmm seed must be one int64 value for each of "
                        f"{lanes} lane(s)")
    if lanes > 65535:
        raise ValueError(f"td_vmm takes at most 65535 lanes, got {lanes}")
    if not 1 <= bits_a <= 8 or not 1 <= bits_w <= 8:
        raise ValueError(f"bits_a, bits_w must be in 1..8, got "
                         f"{bits_a}, {bits_w}")
    if not 0 <= k_true <= x.shape[-1]:
        raise ValueError(f"k_true={k_true} outside [0, {x.shape[-1]}]")
    devs = {t.device for t in (x, w, params, seed)}
    if len(devs) != 1:
        raise ValueError(f"td_vmm operands on several devices: {devs}")


def td_vmm(x_int: torch.Tensor, w_int: torch.Tensor, params: torch.Tensor,
           seed: torch.Tensor, *, bits_a: int, bits_w: int, n_chain: int,
           k_true: int | None = None) -> torch.Tensor:
    """Noisy bit-serial TD product of signed codes, (M, N) float32, or
    (P, M, N) for P lanes; with w (L, K, N), lane p reads w[p % L]."""
    global launches
    if k_true is None:
        k_true = x_int.shape[-1]
    _check(x_int, w_int, params, seed, bits_a, bits_w, k_true)
    if x_int.device.type == "cpu":
        return td_vmm_plain(x_int, w_int, params, seed, bits_a=bits_a,
                            bits_w=bits_w, n_chain=n_chain, k_true=k_true)
    if x_int.device.type != "cuda":
        raise ValueError(f"td_vmm runs on cuda or cpu, not {x_int.device}")
    x = x_int.contiguous()
    w = w_int.contiguous()
    params = params.contiguous()
    seed = seed.contiguous()                 # lane l reads seed + l
    lanes = x.shape[0] if x.dim() == 3 else 1
    m, k = x.shape[-2:]
    n = w.shape[-1]
    out = torch.empty(x.shape[:-1] + (n,), dtype=torch.float32,
                      device=x.device)
    if m and n and lanes:
        plan = td_vmm_plan(m, k, n, n_chain, bits_a)
        scratch = counters = None
        if plan.route == "split":
            scratch = torch.empty((lanes, plan.n_seg, m, n),
                                  dtype=torch.float32, device=x.device)
            counters = _zeroed_counters(lanes * n, x.device)
        rc = _kernel()(x.data_ptr(), w.data_ptr(), params.data_ptr(),
                       seed.data_ptr(), out.data_ptr(),
                       None if scratch is None else scratch.data_ptr(),
                       None if counters is None else counters.data_ptr(),
                       m, n, k, n_chain, k_true, bits_a, bits_w,
                       int(plan.route == "split"), lanes,
                       k * n if w.dim() == 3 else 0,
                       w.shape[0] if w.dim() == 3 else 1,
                       build.stream_ptr(x.device))
        build.check(rc, "td_vmm")
        launches += 1
    return out


def _by_lane(fn, x_int, w_int, params, seed, **kw) -> torch.Tensor:
    """``fn`` over the lanes of a lane call, one single-lane call a lane,
    stacked; a single-lane call as it is."""
    if x_int.dim() == 2:
        return fn(x_int, w_int, params, seed, **kw)
    params = params.reshape(-1, 2)
    seed = seed.reshape(-1)
    return torch.stack([
        fn(x_int[p], w_int[p % w_int.shape[0]] if w_int.dim() == 3
           else w_int, params[p],
           seed[p:p + 1], **kw) for p in range(x_int.shape[0])])


def td_vmm_plain(x_int: torch.Tensor, w_int: torch.Tensor,
                 params: torch.Tensor, seed: torch.Tensor, *, bits_a: int,
                 bits_w: int, n_chain: int,
                 k_true: int | None = None) -> torch.Tensor:
    """The kernel's function in plain PyTorch, with the Pallas kernel's
    order of float operations (per segment: 2^b-weighted planes summed
    LSB first, then ``out += acc - side_sums``), so that at sigma = 0 it is
    bit-exact with both kernels.  Lanes loop the single-lane version."""
    return _by_lane(_plain_one, x_int, w_int, params, seed, bits_a=bits_a,
                    bits_w=bits_w, n_chain=n_chain, k_true=k_true)


def _plain_one(x_int, w_int, params, seed, *, bits_a, bits_w, n_chain,
               k_true):
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


def td_vmm_split_plain(x_int: torch.Tensor, w_int: torch.Tensor,
                       params: torch.Tensor, seed: torch.Tensor, *,
                       bits_a: int, bits_w: int, n_chain: int,
                       k_true: int | None = None,
                       plan: TdVmmPlan) -> torch.Tensor:
    """The split route in plain PyTorch: each of ``plan``'s segments
    computes its term from its own slice of the contraction into a scratch
    (n_seg, M, N) laid out as the kernel's, and the combine adds them in
    segment order onto k_true * ox * ow.  Bit-identical to `td_vmm_plain`,
    noise included.  Lanes loop the single-lane version."""
    return _by_lane(_split_plain_one, x_int, w_int, params, seed,
                    bits_a=bits_a, bits_w=bits_w, n_chain=n_chain,
                    k_true=k_true, plan=plan)


def _split_plain_one(x_int, w_int, params, seed, *, bits_a, bits_w,
                     n_chain, k_true, plan):
    m, k = x_int.shape
    n = w_int.shape[1]
    if k_true is None:
        k_true = k
    dev = x_int.device
    ox, ow = 2 ** (bits_a - 1), 2 ** (bits_w - 1)
    n_seg = plan.n_seg
    sigma = params[0]
    q = torch.clamp(params[1], min=1.0)
    seed_v = seed.reshape(()).to(torch.int64)
    row_i = torch.arange(m, dtype=torch.int64, device=dev)[:, None]
    col_i = torch.arange(n, dtype=torch.int64, device=dev)[None, :]
    scratch = torch.empty((n_seg, m, n), dtype=torch.float32, device=dev)
    for s in range(n_seg):
        # this segment's slice of the contraction, offset-encoded, 0
        # past k_true
        k0, k1 = s * n_chain, min((s + 1) * n_chain, k)
        live = torch.arange(k0, k1, device=dev) < k_true
        xu = torch.where(live, x_int[:, k0:k1] + ox, 0)
        wu = torch.where(live[:, None], w_int[k0:k1] + ow, 0)
        n_live = min(max(float(k_true) - float(s) * n_chain, 1.0),
                     float(n_chain))
        sig_seg = sigma * torch.sqrt(torch.tensor(
            n_live, dtype=torch.float32, device=dev) / float(n_chain))
        wf = wu.to(torch.float32)
        acc = torch.zeros((m, n), dtype=torch.float32, device=dev)
        for b in range(bits_a):
            part = ((xu >> b) & 1).to(torch.float32) @ wf
            idx = (((b * n_seg + s) * m + row_i) & MASK32) * n + col_i
            part = part + sig_seg * gauss_noise(idx, seed_v)
            part = q * torch.round(part / q)
            acc = acc + float(2 ** b) * part
        corr = float(ow) * xu.sum(-1).to(torch.float32)[:, None] \
            + float(ox) * wu.sum(0).to(torch.float32)[None, :]
        scratch[s] = acc - corr
    out = torch.full((m, n), float(k_true * ox * ow), dtype=torch.float32,
                     device=dev)
    for s in range(n_seg):
        out = out + scratch[s]
    return out
