"""The time-domain VMM of the paper's macro, worked out again in plain
PyTorch for the benchmark's output check.

A td product of signed LSQ codes x (M, K) and w (K, N) is, per bit plane
b of the offset-encoded activations (x + 2^(bits_a - 1)) and per chain
segment s of ``n_chain`` rows of K, the integer partial sum P, plus chain
noise sigma sqrt(live_s / n_chain) z, rounded by the TDC to a multiple of
q; the planes recombine by 2^b and the offset side sums come off.  z is a
standard normal drawn by a counter hash (lowbias32, Box-Muller) from the
element's index ((b n_seg + s) M + m) N + n and the call's seed.

With q = 1 (the configuration's operating point) and P an integer below
2^14, round(P + eps) = P + round(eps) (half to even) unless eps lies within a float32 ulp
of a half-integer, and the whole product is exactly

    x @ w + sum_{b, s} 2^b round(eps_{b, s, m, n})

which is evaluated as an exact float32 product of the codes (every
partial sum an integer below 2^24) plus a correction that depends only on
the call's shape (K, N, M) and seed: a ``NoiseBook``.  The book keeps the
few elements whose |eps| reaches a half-integer within ``EDGE`` apart;
for those P is computed from the operands and the rounding done as the
hardware does it, in float32.
"""
from __future__ import annotations

import torch

GOLDEN = 0x9E3779B9
MASK32 = 0xFFFFFFFF
TWO_PI_F32 = 6.28318548           # float32(2 pi)
EDGE = 2.0 ** -8                  # half-integer band that needs P
CHUNK = 1 << 25                   # noise elements generated at once
EDGE_BLOCK = 1 << 16              # edge elements whose P is summed at once


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & MASK32


def hash32(x: torch.Tensor) -> torch.Tensor:
    """lowbias32 on int64 values in [0, 2^32)."""
    x = x & MASK32
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def _hash32_int(x: int) -> int:
    x &= MASK32
    x ^= x >> 16
    x = (x * 0x7FEB352D) & MASK32
    x ^= x >> 15
    x = (x * 0x846CA68B) & MASK32
    return x ^ (x >> 16)


def derive_seed(k0: int, k1: int) -> int:
    """The uint32 noise seed of a two-word PRNG key: hash32(k0 ^ GOLDEN)
    ^ k1.  Serving passes no key, which is the key (0, 0)."""
    return _hash32_int((k0 & MASK32) ^ GOLDEN) ^ (k1 & MASK32)


def _uniform(h: torch.Tensor) -> torch.Tensor:
    return (h >> 8).to(torch.float32) * (1.0 / 16777216.0) \
        + (0.5 / 16777216.0)


def gauss(idx: torch.Tensor, seed: int) -> torch.Tensor:
    """Standard normal of each int64 index under ``seed`` (float32)."""
    i = (idx & MASK32) ^ (seed & MASK32)
    u1 = _uniform(hash32(i))
    u2 = _uniform(hash32(i ^ GOLDEN))
    return torch.sqrt(-2.0 * torch.log(u1)) * torch.cos(TWO_PI_F32 * u2)


class NoiseBook:
    """What the noise adds to every product of one call shape: ``dense``
    (M, N) float32, the sum of 2^b round(eps) over the elements whose
    rounding does not depend on P, and the elements that do (``edge_*``:
    row, column, plane, segment, eps).  Rows are worked out when a
    product first needs them (`ensure`)."""

    def __init__(self, k: int, n: int, m: int, bits_a: int, n_chain: int,
                 sigma: float, seed: int, device):
        self.k, self.n, self.m = k, n, m
        self.bits_a, self.seed = bits_a, seed
        n_seg = max(1, -(-k // n_chain))
        self.n_seg = n_seg
        live = torch.tensor([float(min(n_chain, max(1, k - s * n_chain)))
                             for s in range(n_seg)], dtype=torch.float32,
                            device=device)
        self.sig = torch.tensor(sigma, dtype=torch.float32, device=device) \
            * torch.sqrt(live / float(n_chain))
        self.dense = torch.zeros((m, n), dtype=torch.float32, device=device)
        self.done = torch.zeros(m, dtype=torch.bool, device=device)
        self._parts: list = []
        self._csr = None
        self.device = device

    def ensure(self, rows: torch.Tensor) -> None:
        """Work out the rows of ``rows`` not worked out yet."""
        todo = torch.unique(rows[~self.done[rows]])
        if todo.numel() == 0:
            return
        dev, n, m = self.device, self.n, self.m
        planes = self.bits_a * self.n_seg
        ps = torch.arange(planes, dtype=torch.int64, device=dev)
        cols = torch.arange(n, dtype=torch.int64, device=dev)
        step = max(1, CHUNK // (planes * n))
        thresh = 0.5 - EDGE
        for r0 in range(0, todo.numel(), step):
            rr = todo[r0:r0 + step]
            idx = ((ps[:, None, None] * m + rr[None, :, None]) * n
                   + cols[None, None, :])
            eps = self.sig[ps % self.n_seg][:, None, None] \
                * gauss(idx, self.seed)
            keep = torch.nonzero(eps.abs() >= thresh)
            pl, ri, col = keep[:, 0], keep[:, 1], keep[:, 2]
            e = eps[pl, ri, col]
            row = rr[ri]
            seg, plane = pl % self.n_seg, pl // self.n_seg
            mag = e.abs()
            edge = (mag - torch.floor(mag) - 0.5).abs() < EDGE
            inner = ~edge
            self.dense.index_put_(
                (row[inner], col[inner]),
                torch.round(e[inner]) * torch.pow(
                    2.0, plane[inner].to(torch.float32)), accumulate=True)
            self._parts.append((row[edge], col[edge], plane[edge],
                                seg[edge], e[edge]))
            self._csr = None
        self.done[todo] = True

    def edges(self) -> tuple:
        """The P-dependent elements sorted by row, with each row's start:
        (ptr (M + 1,), col, plane, seg, eps)."""
        if self._csr is None:
            dev = self.device
            if self._parts:
                row, col, plane, seg, eps = (torch.cat(t)
                                             for t in zip(*self._parts))
            else:
                row = col = plane = seg = torch.zeros(0, dtype=torch.int64,
                                                      device=dev)
                eps = torch.zeros(0, dtype=torch.float32, device=dev)
            self._parts = [(row, col, plane, seg, eps)] if row.numel() \
                else []
            order = torch.argsort(row, stable=True)
            ptr = torch.zeros(self.m + 1, dtype=torch.int64, device=dev)
            ptr[1:] = torch.cumsum(torch.bincount(row, minlength=self.m), 0)
            self._csr = (ptr, col[order], plane[order], seg[order],
                         eps[order])
        return self._csr


class TDMacro:
    """The configuration's TD product: LSQ codes, the exact product, the
    noise and the TDC rounding at q = 1, and the dequantization."""

    def __init__(self, bits_a: int, bits_w: int, n_chain: int, sigma: float,
                 tdc_q: float, seed: int, device):
        if float(tdc_q) != 1.0:
            raise ValueError(f"the reference's TD product takes q = 1, not "
                             f"{tdc_q}")
        self.bits_a, self.bits_w, self.n_chain = bits_a, bits_w, n_chain
        self.sigma, self.seed, self.device = float(sigma), seed, device
        self._books: dict[tuple, NoiseBook] = {}

    def book(self, k: int, n: int, m: int) -> NoiseBook:
        key = (k, n, m)
        if key not in self._books:
            self._books[key] = NoiseBook(k, n, m, self.bits_a, self.n_chain,
                                         self.sigma, self.seed, self.device)
        return self._books[key]

    @staticmethod
    def codes(v: torch.Tensor, s: torch.Tensor, bits: int) -> torch.Tensor:
        """Signed LSQ codes clip(round(v / s)), the division in the dtype
        of v and s (bf16 in the configuration), as float32."""
        qn, qp = -(2 ** (bits - 1)), 2 ** (bits - 1) - 1
        dt = torch.promote_types(v.dtype, s.dtype)
        s_ = torch.clamp(s.to(device=v.device, dtype=dt), min=1e-8)
        return torch.clamp(torch.round(v.to(dt) / s_), qn, qp).to(
            torch.float32)

    def product(self, xc: torch.Tensor, wc: torch.Tensor, rows: torch.Tensor,
                m: int) -> torch.Tensor:
        """The integer result of the macro, float32 (R, N): codes xc (R, K)
        of the rows ``rows`` (indices into a call of ``m`` rows) against
        codes wc (K, N)."""
        k, n = wc.shape
        y = xc @ wc
        if self.sigma == 0.0:
            return y
        bk = self.book(k, n, m)
        bk.ensure(rows)
        y += bk.dense[rows]
        ptr, e_col, e_plane, e_seg, e_eps = bk.edges()
        cnt = ptr[rows + 1] - ptr[rows]
        total = int(cnt.sum())
        if total == 0:
            return y
        dev = y.device
        who = torch.repeat_interleave(torch.arange(len(rows), device=dev),
                                      cnt)
        ent = (torch.repeat_interleave(ptr[rows] - (torch.cumsum(cnt, 0)
                                                     - cnt), cnt)
               + torch.arange(total, device=dev))
        col, plane, seg, eps = e_col[ent], e_plane[ent], e_seg[ent], \
            e_eps[ent]
        ox, ow = 2 ** (self.bits_a - 1), 2 ** (self.bits_w - 1)
        pad = bk.n_seg * self.n_chain - k
        xu = torch.nn.functional.pad(xc + ox, (0, pad)).to(torch.int64)
        wu = torch.nn.functional.pad(wc + ow, (0, 0, 0, pad)).to(torch.int64)
        xu = xu.reshape(len(rows), bk.n_seg, self.n_chain)
        wu = wu.reshape(bk.n_seg, self.n_chain, n)
        for c0 in range(0, total, EDGE_BLOCK):
            sl = slice(c0, c0 + EDGE_BLOCK)
            bits = (xu[who[sl], seg[sl]] >> plane[sl, None]) & 1
            p = (bits * wu[seg[sl], :, col[sl]]).sum(-1).to(torch.float32)
            r = torch.round(p + eps[sl]) - p
            y.index_put_((who[sl], col[sl]),
                         r * torch.pow(2.0, plane[sl].to(torch.float32)),
                         accumulate=True)
        return y

    def linear(self, x: torch.Tensor, w: torch.Tensor, s_a: torch.Tensor,
               s_w: torch.Tensor, rows: torch.Tensor, m: int,
               wc: torch.Tensor | None = None) -> torch.Tensor:
        """y = dequantized td product of x (R, K) and w (K, N), in the dtype
        of x and w; ``wc`` the codes of w when the caller has them."""
        xc = self.codes(x, s_a, self.bits_a)
        if wc is None:
            wc = self.codes(w, s_w, self.bits_w)
        y = self.product(xc, wc, rows, m)
        scale = torch.clamp(s_a, min=1e-8) * torch.clamp(s_w, min=1e-8)
        return (y * scale).to(torch.promote_types(x.dtype, w.dtype))

