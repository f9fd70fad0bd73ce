"""Time-to-digital converter models (port of `repro/core/tdc.py`, paper
Section III-A, Eq. 8-10, Figs. 5-7).

Two architectures:
  * SAR-TDC  -- successive approximation, binary-decaying delay of the
                faster signal (Fig. 5a, Eq. 10),
  * hybrid   -- gray-code counter driven by a ring oscillator of L_osc
                TD-AND cells for the MSBs + a small SAR-TDC for the LSBs
                (Fig. 5b, Eq. 8) with closed-form optimal L_osc (Eq. 9).

`range_units` is the maximum TD input in unit-cell delays (delay steps x
R).  Fig. 6's observation that CNN output ranges concentrate lets the range
be clipped to RANGE_KAPPA * sqrt(N) * (2^B - 1) steps.

Every entry point takes python scalars (the reference's float64 scalar
path, kept as python float math) or float32 tensors (elementwise, in the
reference's op order).  Periphery energies and the unit delay come from a
`core.techlib.TechLib` (``lib=``).
"""
from __future__ import annotations

import functools
import math

import torch

from repro_torch.core import cells
from repro_torch.core import constants as C
from repro_torch.core import fp
from repro_torch.core.cells import f32
from repro_torch.core.techlib import DEFAULT_LIB, TechLib


def _is_scalar(*xs) -> bool:
    return all(isinstance(x, (int, float)) for x in xs)


@functools.lru_cache(maxsize=4096)
def _e_at_cached(e_nom: float, vdd: float) -> float:
    """Cached scalar voltage-scaled energy (python float math)."""
    return float(e_nom) * (vdd / C.VDD_NOM) ** 2


def _e_at(e_nom: float, vdd):
    if _is_scalar(vdd):
        return _e_at_cached(float(e_nom), float(vdd))
    return e_nom * (f32(vdd) / C.VDD_NOM) ** 2


@functools.lru_cache(maxsize=4096)
def _tau_at_cached(tau_unit: float, vdd: float) -> float:
    """The float32 unit delay at ``vdd`` as a python float, computed on the
    CPU."""
    return float(cells.delay_at_vdd(f32(tau_unit), f32(vdd)))


def _tau_at(vdd, tau_unit: float):
    if _is_scalar(vdd):
        return _tau_at_cached(float(tau_unit), float(vdd))
    vdd = f32(vdd)
    return cells.delay_at_vdd(f32(tau_unit, vdd.device), vdd)


def _lsb_bits(l_osc):
    """ceil(1 + log2(L_osc)) -- SAR bits covering the 2*L_osc LSB window."""
    if _is_scalar(l_osc):
        return math.ceil(1.0 + math.log2(l_osc))
    return torch.ceil(1.0 + fp.log2(f32(l_osc)))


# ---------------------------------------------------------------------------
# Output-range model (Fig. 6)
# ---------------------------------------------------------------------------
def effective_range_steps(n, bits: int, clip_to_observed: bool = True):
    """Maximum TDC range in delay steps, elementwise in n: the full N (2^B
    - 1), or the observed kappa sqrt(N) (2^B - 1) when smaller."""
    if _is_scalar(n):
        full = float(n) * (2.0 ** bits - 1.0)
        if not clip_to_observed:
            return full
        observed = C.RANGE_KAPPA * math.sqrt(float(n)) * (2.0 ** bits - 1.0)
        return min(full, observed)
    nf = f32(n)
    full = nf * (2.0 ** bits - 1.0)
    if not clip_to_observed:
        return full
    observed = C.RANGE_KAPPA * fp.sqrt(nf) * (2.0 ** bits - 1.0)
    return torch.minimum(full, observed)


def range_bits(range_steps):
    """TDC output bit width covering the range (elementwise)."""
    if _is_scalar(range_steps):
        return max(1, int(math.ceil(math.log2(max(2.0, range_steps)))))
    steps = torch.clamp(f32(range_steps), min=2.0)
    return torch.clamp(torch.ceil(fp.log2(steps)), min=1.0)


def _exp2(k):
    """2 ** k for an integer-valued k (exact)."""
    if _is_scalar(k):
        return 2.0 ** k
    return fp.pow(2.0, k)


# ---------------------------------------------------------------------------
# SAR-TDC (Eq. 10)
# ---------------------------------------------------------------------------
def sar_tdc_energy(b_tdc, m=C.M_DEFAULT, vdd=C.VDD_NOM,
                   lib: TechLib = DEFAULT_LIB):
    """Eq. 10: E = E_TD-AND * (M+1)/M * (2^B - 2) + B * E_sample (the
    reference delay to max_in/2 is shared by all M chains)."""
    e_and = _e_at(lib.e_td_and, vdd)
    e_smp = _e_at(lib.e_sample, vdd)
    return e_and * (m + 1) / m * (_exp2(b_tdc) - 2.0) + b_tdc * e_smp


def sar_tdc_latency(b_tdc, vdd=C.VDD_NOM, lib: TechLib = DEFAULT_LIB):
    """Binary search: sum of binary-decaying delays ~ 2^B_tdc unit delays."""
    tau = _tau_at(vdd, lib.tau_unit)
    return _exp2(b_tdc) * tau


def sar_tdc_area(b_tdc):
    """2^B_tdc - 2 TD-AND cells + B_tdc samplers + B_tdc XOR."""
    a_pitch = C.AREA_PER_PITCH
    a_and = C.N_TRANS_TD_AND * a_pitch
    a_ff = 22 * a_pitch       # flipflop ~ 22 pitches
    a_xor = 10 * a_pitch
    return (_exp2(b_tdc) - 2.0) * a_and + b_tdc * (a_ff + a_xor)


# ---------------------------------------------------------------------------
# Hybrid TDC (Eq. 8-9)
# ---------------------------------------------------------------------------
def hybrid_tdc_energy(range_units, l_osc, m=C.M_DEFAULT, vdd=C.VDD_NOM,
                      lib: TechLib = DEFAULT_LIB):
    """Eq. 8 with NR == `range_units` (max chain output in unit delays):

      E = (E_cnt/M + E_cnt,load) * NR / (2 L_osc)
        + 2 NR E_TD-AND / M
        + E_TD-AND * 2^ceil(1 + log2(L_osc))
        + ceil(1 + log2(L_osc)) * E_sample
    """
    e_and = _e_at(lib.e_td_and, vdd)
    e_smp = _e_at(lib.e_sample, vdd)
    e_cnt = _e_at(lib.e_cnt, vdd)
    e_cl = _e_at(lib.e_cnt_load, vdd)
    lsb_bits = _lsb_bits(l_osc)
    return ((e_cnt / m + e_cl) * range_units / (2.0 * l_osc)
            + 2.0 * range_units * e_and / m
            + e_and * _exp2(lsb_bits)
            + lsb_bits * e_smp)


def optimal_l_osc(range_units, m=C.M_DEFAULT, vdd=C.VDD_NOM,
                  lib: TechLib = DEFAULT_LIB):
    """Eq. 9 closed form (Gauss brackets ignored), then integer refinement.

      L_osc ~ (sqrt((E_cnt/M + E_cnt,load) * 2 E_TD-AND NR ln4) - E_sample)
              / (4 E_TD-AND ln2)

    Python scalars refine by scanning the [L0/2, 2*L0 + 2] window.  Tensors
    refine over the window's candidate optima only: within a dyadic block
    (2^(k-1), 2^k] the bracketed Eq. 8 is strictly decreasing in L, so the
    window minimum lies on a block endpoint 2^k, the window edge, or L0
    itself (first among the candidates, so that a tie keeps it, as the
    scan's strict < does).
    """
    if _is_scalar(range_units, vdd):
        e_and = _e_at(lib.e_td_and, vdd)
        e_smp = _e_at(lib.e_sample, vdd)
        e_cnt = _e_at(lib.e_cnt, vdd)
        e_cl = _e_at(lib.e_cnt_load, vdd)
        num = math.sqrt((e_cnt / m + e_cl) * 2.0 * e_and * range_units
                        * math.log(4.0)) - e_smp
        l0 = num / (4.0 * e_and * math.log(2.0))
        l0 = max(1, int(round(l0)))
        best_l, best_e = l0, hybrid_tdc_energy(range_units, l0, m, vdd, lib)
        for cand in range(max(1, l0 // 2), 2 * l0 + 2):
            e = hybrid_tdc_energy(range_units, cand, m, vdd, lib)
            if e < best_e:
                best_l, best_e = cand, e
        return best_l
    ru = f32(range_units)
    e_and = _e_at(lib.e_td_and, vdd)
    e_smp = _e_at(lib.e_sample, vdd)
    e_cnt = _e_at(lib.e_cnt, vdd)
    e_cl = _e_at(lib.e_cnt_load, vdd)
    num = fp.sqrt((e_cnt / m + e_cl) * 2.0 * e_and * ru
                  * math.log(4.0)) - e_smp
    l0 = torch.clamp(torch.round(num / (4.0 * e_and * math.log(2.0))),
                     min=1.0)
    lo = torch.clamp(torch.floor(l0 / 2.0), min=1.0)
    hi = 2.0 * l0 + 2.0
    k0 = torch.floor(fp.log2(l0))
    offs = torch.arange(-1.0, 3.0, device=ru.device).reshape(
        (4,) + (1,) * l0.ndim)
    powers = _exp2(k0[None, ...] + offs)
    block_ends = torch.minimum(torch.maximum(powers, lo[None, ...]),
                               hi[None, ...])
    rest = torch.sort(torch.cat([block_ends, hi[None, ...]], dim=0),
                      dim=0).values
    cand = torch.cat([l0[None, ...], rest], dim=0)
    es = hybrid_tdc_energy(ru[None, ...], cand, m,
                           f32(vdd, ru.device)[None, ...], lib)
    best = torch.argmin(es, dim=0)
    return torch.gather(cand, 0, best[None, ...])[0]


def hybrid_tdc_latency(range_units, l_osc, vdd=C.VDD_NOM,
                       lib: TechLib = DEFAULT_LIB):
    """Counter runs concurrently with the chain; after the edge arrives,
    the LSB SAR covers a 2*L_osc window -> ~2*L_osc unit delays +
    sampling."""
    tau = _tau_at(vdd, lib.tau_unit)
    lsb_bits = _lsb_bits(l_osc)
    return 2.0 * l_osc * tau + lsb_bits * 4.0 * tau


def hybrid_tdc_area(range_units, l_osc, m=C.M_DEFAULT):
    """Ring osc (L_osc TD-ANDs, shared) + gray counter (shared) + per-chain
    MSB sample register + per-chain LSB SAR."""
    a_pitch = C.AREA_PER_PITCH
    a_and = C.N_TRANS_TD_AND * a_pitch
    a_ff = 22 * a_pitch
    msb_bits = range_bits(range_units / (2.0 * l_osc) + 1.0)
    a_counter = msb_bits * 9.0 * a_ff          # gray counter synthesis est.
    lsb_bits = _lsb_bits(l_osc)
    a_shared = l_osc * a_and + a_counter
    a_per_chain = msb_bits * a_ff + sar_tdc_area(lsb_bits)
    return a_shared / m + a_per_chain


# ---------------------------------------------------------------------------
# Full TDC choice used by the comparison (Fig. 7 -> hybrid)
# ---------------------------------------------------------------------------
def tdc_energy_per_vmm(n, bits: int, redundancy, m=C.M_DEFAULT,
                       vdd=C.VDD_NOM, arch: str = "hybrid",
                       clip_range: bool = True, lib: TechLib = DEFAULT_LIB):
    """Energy of one chain conversion, E_TDC(N, M) of Eq. 7."""
    steps = effective_range_steps(n, bits, clip_range)
    units = steps * redundancy
    if arch == "hybrid":
        l = optimal_l_osc(units, m, vdd, lib)
        return hybrid_tdc_energy(units, l, m, vdd, lib)
    elif arch == "sar":
        return sar_tdc_energy(range_bits(steps), m, vdd, lib)
    raise ValueError(f"unknown TDC arch {arch!r}")
