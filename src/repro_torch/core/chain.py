"""Compute-chain error statistics (port of `repro/core/chain.py`, paper
Section III, Eq. 2-6) and the redundancy solver.

The chain of N TD-MAC cells accumulates per-cell errors.  With input
statistics P(x), P(w):

  mu_err,cell      = sum_{i,j} INL(i,j) P(x=i) P(w=j)                 (Eq. 2)
  sigma^2_err,cell = E[Var(err|x,w)]  (EVPV)  +  Var(INL)  (VHM)      (Eq. 3)
  sigma^2_chain    = N (EVPV + VHM)                                   (Eq. 5)
  mu ~ 1/R,  EVPV ~ 1/R,  VHM ~ 1/R^2                                 (Eq. 6)

The paper calibrates the mean to zero and requires
SIGMA_CONFIDENCE * sigma_chain <= err_max.

The memoized scalar helpers (`cell_stats`, `_var_coeffs_scalar`) compute
on the CPU whatever device a sweep runs on, and cache python floats.
`simulate_chain_errors` is the Monte-Carlo check the formulas are held
to: it draws with a ``torch.Generator`` on ``device`` (None: CUDA), so its
samples are torch's, not the reference's threefry stream; the two agree
in distribution.
"""
from __future__ import annotations

import dataclasses
import functools
import math

import torch

from repro_torch import device as device_mod
from repro_torch.core import cells
from repro_torch.core import constants as C
from repro_torch.core import fp
from repro_torch.core.cells import device_of, f32
from repro_torch.core.techlib import DEFAULT_LIB, TechLib


@dataclasses.dataclass(frozen=True)
class CellStats:
    mu: float        # Eq. 2, delay steps
    evpv: float      # Eq. 3 first term, steps^2
    vhm: float       # Eq. 3 second term, steps^2

    @property
    def var(self) -> float:
        return self.evpv + self.vhm


@functools.lru_cache(maxsize=65536)
def cell_stats(bits: int, redundancy: float, vdd: float = C.VDD_NOM,
               p_x_one: float = C.P_X_ONE,
               w_bit_sparsity: float = C.W_BIT_SPARSITY,
               lib: TechLib = DEFAULT_LIB) -> CellStats:
    """The input-dependent cell statistics combined with the input
    statistics by the laws of total expectation / variance (Eq. 2-3),
    memoized on the hashable scalar arguments (``lib`` included)."""
    p_x, p_w = cells.input_distribution(bits, p_x_one, w_bit_sparsity)
    pxw = p_x[:, None] * p_w[None, :]                      # (2, 2^B)
    inl = cells.inl_table(bits, redundancy, lib)           # (2, 2^B)
    var = cells.cell_delay_variance(bits, redundancy, vdd, lib)
    mu = fp.fsum(inl * pxw, (-2, -1))
    evpv = fp.fsum(var * pxw, (-2, -1))
    vhm = fp.fsum(inl ** 2 * pxw, (-2, -1)) - mu ** 2
    return CellStats(mu=float(mu), evpv=float(evpv), vhm=float(vhm))


def chain_stats(n, st: CellStats) -> tuple[torch.Tensor, torch.Tensor]:
    """Eq. 4-5: (mu_chain, sigma_chain) for chain length n (a float32
    tensor of n's shape, on n's device)."""
    n = f32(n)
    return n * st.mu, fp.sqrt(n * (st.evpv + st.vhm))


@dataclasses.dataclass(frozen=True)
class CellVarCoeffs:
    """Exact rational decomposition of the cell statistics in R (Eq. 6):

        mu(R)       = mu1 / R
        var_cell(R) = a1 / R + c / R^2

    Fields are float32 tensors of the broadcast shape of (vdd, p_x_one,
    w_bit_sparsity)."""
    a1: torch.Tensor
    c: torch.Tensor
    mu1: torch.Tensor

    def var(self, redundancy) -> torch.Tensor:
        r = f32(redundancy, self.a1.device)
        return self.a1 / r + self.c / r ** 2


def cell_var_coeffs(bits: int, vdd=C.VDD_NOM, p_x_one=C.P_X_ONE,
                    w_bit_sparsity=C.W_BIT_SPARSITY,
                    lib: TechLib = DEFAULT_LIB) -> CellVarCoeffs:
    """Coefficients of the exact var_cell(R) = a1/R + c/R^2 model, batched
    over (vdd, p_x_one, w_bit_sparsity)."""
    dev = device_of(vdd, p_x_one, w_bit_sparsity)
    p_x, p_w = cells.input_distribution(
        bits, f32(p_x_one, dev), f32(w_bit_sparsity, dev))
    pxw = p_x[..., :, None] * p_w[..., None, :]            # (*S, 2, 2^B)
    inl1 = cells.inl_table(bits, 1.0, lib, device=dev)     # (2, 2^B)
    mu1 = fp.fsum(inl1 * pxw, (-2, -1))
    m2_1 = fp.fsum(inl1 ** 2 * pxw, (-2, -1))
    planes = cells._bit_planes(bits, dev)                  # (2^B, B)
    act = fp.fsum(planes * cells._pow2(bits, dev)[None, :])
    n_byp = fp.fsum(1.0 - planes)
    vdd = f32(vdd, dev)
    sig_u = cells.sig_rel_at_vdd(f32(lib.sig_u_rel, dev), vdd)
    sig_n = cells.sig_rel_at_vdd(f32(lib.sig_nand_rel, dev), vdd)
    p1, p0 = p_x[..., 1], p_x[..., 0]
    a1 = p1 * fp.fsum(p_w * act) * sig_u ** 2
    k_byp = p1 * fp.fsum(p_w * n_byp) + p0 * bits
    c = k_byp * sig_n ** 2 + (m2_1 - mu1 ** 2)
    return CellVarCoeffs(a1=a1, c=c, mu1=mu1)


def chain_sigma(n, bits: int, redundancy, vdd=C.VDD_NOM,
                p_x_one=C.P_X_ONE, w_bit_sparsity=C.W_BIT_SPARSITY,
                lib: TechLib = DEFAULT_LIB) -> torch.Tensor:
    """sigma_err,chain in delay steps, batched over (n, redundancy, vdd)."""
    co = cell_var_coeffs(bits, vdd, p_x_one, w_bit_sparsity, lib)
    return fp.sqrt(f32(n, co.a1.device) * co.var(redundancy))


@functools.lru_cache(maxsize=65536)
def _var_coeffs_scalar(bits: int, vdd: float, p_x_one: float,
                       w_bit_sparsity: float,
                       lib: TechLib = DEFAULT_LIB) -> tuple[float, float]:
    """(a1, c) as python floats, memoized: the scalar solver's hot path."""
    co = cell_var_coeffs(bits, vdd, p_x_one, w_bit_sparsity, lib)
    return float(co.a1), float(co.c)


def solve_redundancy(n, bits: int, sigma_max, vdd=C.VDD_NOM,
                     r_max: int = 4096, p_x_one=C.P_X_ONE,
                     w_bit_sparsity=C.W_BIT_SPARSITY,
                     lib: TechLib = DEFAULT_LIB):
    """Smallest integer R with sigma_chain(N, B, R) <= sigma_max, batched
    over (n, sigma_max, vdd) (python scalars return a python int).

    Closed form: with var_cell = a1/R + c/R^2 exactly,
        R >= (N a1 + sqrt(N^2 a1^2 + 4 s^2 N c)) / (2 s^2),
    then a +-1 monotone correction absorbs the float error of the root.
    Returns r_max when the budget is unattainable below it.
    """
    if all(isinstance(x, (int, float))
           for x in (n, sigma_max, vdd, p_x_one, w_bit_sparsity)):
        a1, c = _var_coeffs_scalar(bits, float(vdd), float(p_x_one),
                                   float(w_bit_sparsity), lib)
        nf, s2 = float(n), float(sigma_max) ** 2
        root = (nf * a1 + math.sqrt((nf * a1) ** 2 + 4.0 * s2 * nf * c)) \
            / (2.0 * s2)
        r0 = math.ceil(root)
        for r in (r0 - 1, r0, r0 + 1):
            r = min(max(r, 1), r_max)
            if nf * (a1 / r + c / (r * r)) <= s2:
                return r
        return min(max(r0 + 1, 1), r_max)
    dev = device_of(n, sigma_max, vdd, p_x_one, w_bit_sparsity)
    scalar = all(not isinstance(x, torch.Tensor) or x.ndim == 0
                 for x in (n, sigma_max, vdd))
    co = cell_var_coeffs(bits, f32(vdd, dev), p_x_one, w_bit_sparsity, lib)
    nf = f32(n, dev)
    s2 = f32(sigma_max, dev) ** 2
    root = (nf * co.a1
            + fp.sqrt((nf * co.a1) ** 2 + 4.0 * s2 * nf * co.c)) / (2.0 * s2)
    r0 = torch.ceil(root)
    cand = torch.stack([r0 - 1.0, r0, r0 + 1.0]).clamp(1.0, float(r_max))
    feas = nf * co.var(cand) <= s2
    # infeasible everywhere falls through to the clipped r0+1 candidate,
    # matching the scalar path's r_max cap
    pick = torch.where(feas[0], cand[0],
                       torch.where(feas[1], cand[1], cand[2]))
    out = pick.to(torch.int32)
    return int(out) if scalar else out


def sigma_max_exact() -> float:
    """Exact regime: SIGMA_CONFIDENCE * sigma <= ERR_EXACT_MAX (rounding
    kills everything below half an LSB)."""
    return C.ERR_EXACT_MAX / C.SIGMA_CONFIDENCE


# ---------------------------------------------------------------------------
# Monte-Carlo reference for the law-of-total-variance model: the simulation
# the analytic formulas are validated against.
# ---------------------------------------------------------------------------
def simulate_chain_errors(gen: torch.Generator, n: int, bits: int,
                          redundancy: float, n_mc: int,
                          vdd: float = C.VDD_NOM,
                          p_x_one: float = C.P_X_ONE,
                          w_bit_sparsity: float = C.W_BIT_SPARSITY,
                          lib: TechLib = DEFAULT_LIB,
                          device=None) -> torch.Tensor:
    """(n_mc,) chain error samples on ``device`` (None: CUDA), drawn with
    ``gen`` (a generator of that device): per cell a Bernoulli x, a
    categorical w over `cells.input_distribution`, and the cell error
    INL(x, w) + N(0, Var(x, w))."""
    dev = device_mod.resolve(device)
    p_x, p_w = cells.input_distribution(bits, f32(p_x_one, dev),
                                        f32(w_bit_sparsity, dev))
    xs = (torch.rand((n_mc, n), generator=gen, device=dev)
          < p_x[1]).to(torch.int64)
    # categorical by the inverse of P(w)'s distribution function
    cdf = torch.cumsum(p_w, 0)
    u = torch.rand((n_mc, n), generator=gen, device=dev) * cdf[-1]
    ws = torch.clamp(torch.searchsorted(cdf, u, right=True),
                     max=2 ** bits - 1)
    del u
    cell = xs * 2 ** bits + ws
    del xs, ws
    inl = cells.inl_table(bits, f32(redundancy, dev), lib,
                          device=dev).reshape(-1)
    var = cells.cell_delay_variance(bits, f32(redundancy, dev),
                                    f32(vdd, dev), lib).reshape(-1)
    err = torch.randn((n_mc, n), generator=gen, device=dev) \
        * torch.sqrt(var)[cell]
    err += inl[cell]
    return err.sum(-1)
