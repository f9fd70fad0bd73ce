"""Charge-domain analog VMM model (port of `repro/core/analog.py`, paper
Section IV, Eq. 11-13, Fig. 8).

  E_MAC = E_CAP + E_logic + E_ADC / N                (Eq. 11)
  E_ADC = k1 * ENOB + k2 * 4^ENOB                    (Eq. 12)
  ENOB  = (SNR_dB - 1.76) / 6.02                     (Eq. 13)

A redundancy factor R repeats unit capacitors once the mismatch error
exceeds the error budget (cap mismatch averages ~ 1/sqrt(R)).

Python scalars keep the reference's float math; float32 tensors broadcast
elementwise.  ADC fit, cap and mismatch tables come from a
`core.techlib.TechLib` (``lib=``).
"""
from __future__ import annotations

import math

import torch

from repro_torch.core import constants as C
from repro_torch.core import fp, tdc
from repro_torch.core.cells import device_of, f32
from repro_torch.core.techlib import DEFAULT_LIB, TechLib


def _is_scalar(*xs) -> bool:
    return all(isinstance(x, (int, float)) for x in xs)


def adc_energy(enob, lib: TechLib = DEFAULT_LIB):
    """Eq. 12: k1 * ENOB + k2 * 4^ENOB."""
    if _is_scalar(enob):
        return lib.k1_adc * enob + lib.k2_adc * 4.0 ** enob
    return lib.k1_adc * enob + lib.k2_adc * fp.pow(4.0, enob)


def enob_for_sigma(range_steps, sigma_max_steps):
    """Eq. 13.  SNR_dB = 20 log10(range / sigma), ENOB = (SNR_dB -
    1.76)/6.02, at least 1."""
    if _is_scalar(range_steps, sigma_max_steps):
        snr_db = 20.0 * math.log10(
            max(range_steps / max(sigma_max_steps, 1e-9), 1.0 + 1e-9))
        return max(1.0, (snr_db - 1.76) / 6.02)
    dev = device_of(range_steps, sigma_max_steps)
    ratio = f32(range_steps, dev) \
        / torch.clamp(f32(sigma_max_steps, dev), min=1e-9)
    snr_db = 20.0 * fp.log10(torch.clamp(ratio, min=1.0 + 1e-9))
    return torch.clamp((snr_db - 1.76) / 6.02, min=1.0)


def solve_analog_redundancy(n, bits: int, sigma_max, r_max: int = 4096,
                            lib: TechLib = DEFAULT_LIB):
    """Smallest integer R with sqrt(N) * sigma_cell(R) <= sigma_max."""
    if _is_scalar(n, sigma_max):
        s_cell_needed = sigma_max / math.sqrt(n)
        r = (lib.sig_cap_rel ** 2 * (2.0 ** bits - 1.0)) \
            / max(s_cell_needed, 1e-12) ** 2
        return min(r_max, max(1, int(math.ceil(r))))
    dev = device_of(n, sigma_max)
    nf = f32(n, dev)
    s_cell = torch.clamp(f32(sigma_max, dev) / fp.sqrt(nf),
                         min=1e-12)
    r = lib.sig_cap_rel ** 2 * (2.0 ** bits - 1.0) / s_cell ** 2
    return torch.clamp(torch.ceil(r), 1.0, float(r_max)).to(torch.int32)


def cap_energy_per_mac(bits: int, redundancy, vdd=C.VDD_NOM,
                       p_x_one=C.P_X_ONE, w_bit_sparsity=C.W_BIT_SPARSITY,
                       lib: TechLib = DEFAULT_LIB):
    """Expected charge-redistribution energy of one 1xB MAC: active unit
    caps switch ~ C_u V^2 each, half of it recovered (factor 0.5)."""
    p_act = p_x_one * (1.0 - w_bit_sparsity)
    n_units = (2.0 ** bits - 1.0) * redundancy
    e_unit = lib.c_unit * vdd * vdd * 0.5
    return p_act * n_units * e_unit * (1.0 + lib.leakage_fraction)


def analog_energy_per_mac(n, bits: int, sigma_max, m=C.M_DEFAULT,
                          vdd=C.VDD_NOM, clip_range: bool = True,
                          p_x_one=C.P_X_ONE,
                          w_bit_sparsity=C.W_BIT_SPARSITY,
                          lib: TechLib = DEFAULT_LIB) -> dict:
    """Eq. 11 with the R/ENOB co-solution for a given error budget."""
    r = solve_analog_redundancy(n, bits, sigma_max, lib=lib)
    steps = tdc.effective_range_steps(n, bits, clip_range)
    enob = enob_for_sigma(steps, sigma_max)
    e_cap = cap_energy_per_mac(bits, r, vdd, p_x_one, w_bit_sparsity, lib)
    e_adc = adc_energy(enob, lib)
    e_mac = e_cap + lib.e_pass_logic + e_adc / n
    return {"e_mac": e_mac, "e_cap": e_cap, "e_adc": e_adc,
            "enob": enob, "r": r}


def adc_rate(enob, lib: TechLib = DEFAULT_LIB):
    """Conversion-rate envelope: f_adc_base * 2^(-f_adc_decay (ENOB - 6))."""
    if _is_scalar(enob):
        return lib.f_adc_base * 2.0 ** (-lib.f_adc_decay * (enob - 6.0))
    return lib.f_adc_base * fp.pow(2.0, -lib.f_adc_decay * (enob - 6.0))


def analog_throughput(n, bits: int, sigma_max, m=C.M_DEFAULT,
                      clip_range: bool = True, lib: TechLib = DEFAULT_LIB):
    """MAC/s of M chains sharing one ADC: N * f_ADC (M cancels)."""
    steps = tdc.effective_range_steps(n, bits, clip_range)
    enob = enob_for_sigma(steps, sigma_max)
    return n * adc_rate(enob, lib)


def analog_area(n, bits: int, sigma_max, m=C.M_DEFAULT,
                clip_range: bool = True, lib: TechLib = DEFAULT_LIB):
    """Per-MAC area: cap array + pass logic + amortized ADC (ADC area
    scales with ENOB)."""
    r = solve_analog_redundancy(n, bits, sigma_max, lib=lib)
    steps = tdc.effective_range_steps(n, bits, clip_range)
    enob = enob_for_sigma(steps, sigma_max)
    # MOSCAP unit area ~ 0.30 um^2 incl. wiring; pass transistor 1 pitch/bit
    a_cell = (2.0 ** bits - 1.0) * r * 0.30e-12 + bits * C.AREA_PER_PITCH
    if _is_scalar(n, sigma_max):
        a_adc = lib.adc_area_base \
            * lib.adc_area_per_enob ** max(0.0, enob - 6.0)
    else:
        a_adc = lib.adc_area_base \
            * fp.pow(lib.adc_area_per_enob,
                     torch.clamp(enob - 6.0, min=0.0))
    return a_cell + a_adc / (n * m)
