"""Delay-element and TD-MAC cell models (port of `repro/core/cells.py`,
paper Section II, Figs. 3-4).

  * alpha-power-law voltage scaling of delay / energy / mismatch,
  * eta_ESNR = SNR_cell / sqrt(E_op)  (Eq. 1),
  * the baseline 1xB TD-MAC cell of Fig. 4a: INL table, per-input-pair
    delay variance, and per-MAC energy, as functions of (B, R, input
    stats).

Float32 tensors throughout, in the reference's op order, batched over any
broadcast shape; a python float argument becomes a float32 tensor as the
reference's ``jnp.asarray`` makes it.  Tensors are made on the device of
the first tensor argument (the CPU when there is none).  Device tables
come from a `core.techlib.TechLib` (``lib=``).
"""
from __future__ import annotations

import torch

from repro_torch.core import constants as C
from repro_torch.core import fp
from repro_torch.core.techlib import DEFAULT_LIB, TechLib


def device_of(*xs) -> torch.device:
    """Device of the first tensor among ``xs`` (the CPU when none is)."""
    for x in xs:
        if isinstance(x, torch.Tensor):
            return x.device
    return torch.device("cpu")


def f32(x, device=None) -> torch.Tensor:
    """``x`` as a float32 tensor (on ``device``, else where it lies)."""
    return torch.as_tensor(x, dtype=torch.float32, device=device)


# ---------------------------------------------------------------------------
# Voltage scaling of a delay element (alpha-power law)
# ---------------------------------------------------------------------------
def delay_at_vdd(delay_nom: torch.Tensor, vdd: torch.Tensor) -> torch.Tensor:
    """Stage delay at supply `vdd` given nominal delay at VDD_NOM.

    t(V) ~ V / (V - Vth)^alpha  (alpha-power law).
    """
    num = vdd / fp.pow(vdd - C.VTH_EFF, C.ALPHA_SAT)
    den = C.VDD_NOM / (C.VDD_NOM - C.VTH_EFF) ** C.ALPHA_SAT
    return delay_nom * num / den


def energy_at_vdd(energy_nom: torch.Tensor,
                  vdd: torch.Tensor) -> torch.Tensor:
    """Dynamic switching energy ~ C * V^2."""
    return energy_nom * (vdd / C.VDD_NOM) ** 2


def sig_rel_at_vdd(sig_rel_nom: torch.Tensor,
                   vdd: torch.Tensor) -> torch.Tensor:
    """Relative delay mismatch grows as Vdd approaches Vth (RDF on Vth):
    sigma_t/t ~ 1/(V - Vth)."""
    return sig_rel_nom * (C.VDD_NOM - C.VTH_EFF) / (vdd - C.VTH_EFF)


def snr_cell(sig_rel: torch.Tensor) -> torch.Tensor:
    """SNR of a single delay stage: nominal delay over delay sigma."""
    return 1.0 / sig_rel


def eta_esnr(sig_rel: torch.Tensor, energy: torch.Tensor) -> torch.Tensor:
    """Eq. 1: eta_ESNR = SNR_cell / sqrt(E_op), in 1/sqrt(J)."""
    return snr_cell(sig_rel) / fp.sqrt(energy)


def eta_esnr_vs_vdd(cell_name: str, vdd,
                    lib: TechLib = DEFAULT_LIB) -> torch.Tensor:
    """Fig. 3c: eta_ESNR of a library delay element across supply voltage."""
    dev = device_of(vdd)
    vdd = f32(vdd, dev)
    spec = lib.cell(cell_name)
    sig = sig_rel_at_vdd(f32(spec.sig_rel, dev), vdd)
    e = energy_at_vdd(f32(spec.energy, dev), vdd)
    return eta_esnr(sig, e)


# ---------------------------------------------------------------------------
# Baseline 1xB TD-MAC cell (Fig. 4a): bit i of the weight selects a TD-AND
# cascade of R * 2^i unit cells (x = 1 and w_i = 1) or a single TD-NAND
# bypass.  One delay step == R cascaded unit cells.
# ---------------------------------------------------------------------------
def _pow2(bits: int, device) -> torch.Tensor:
    """(B,) powers of two 2^i, exact."""
    return torch.tensor([2.0 ** i for i in range(bits)], dtype=torch.float32,
                        device=device)


def _bit_planes(bits: int, device=None) -> torch.Tensor:
    """(2^B, B) matrix: row w holds the bits of w."""
    w = torch.arange(2 ** bits, device=device)
    b = torch.arange(bits, device=device)
    return ((w[:, None] >> b[None, :]) & 1).to(torch.float32)


def inl_table(bits: int, redundancy, lib: TechLib = DEFAULT_LIB,
              device=None) -> torch.Tensor:
    """INL(x, w) of the TD-MAC cell in delay-step units, shape (*S, 2, 2^B)
    for `redundancy` of shape S.  Mean-free under a uniform input
    distribution (the calibration), scaling as 1/R (Eq. 6)."""
    dev = device if device is not None else device_of(redundancy)
    planes = _bit_planes(bits, dev)                    # (2^B, B)
    pow2 = _pow2(bits, dev)                            # (B,)
    n_bypass = fp.fsum(1.0 - planes)                   # bypassed | x=1
    active_residue = fp.fsum(planes * fp.sqrt(pow2)[None, :])
    raw_x1 = lib.delta_nand_steps * (n_bypass - fp.fmean(n_bypass)) \
        + 0.35 * lib.delta_nand_steps * (active_residue
                                         - fp.fmean(active_residue))
    raw_x0 = torch.zeros_like(raw_x1)
    table = torch.stack([raw_x0, raw_x1], dim=0)       # (2, 2^B)
    table = table - fp.fmean(table)
    return table / f32(redundancy, dev)[..., None, None]


def cell_delay_variance(bits: int, redundancy, vdd=C.VDD_NOM,
                        lib: TechLib = DEFAULT_LIB) -> torch.Tensor:
    """Var(err_cell | x, w) in delay-step^2 units, shape (*S, 2, 2^B) for
    `redundancy`/`vdd` broadcasting to shape S."""
    dev = device_of(redundancy, vdd)
    r = f32(redundancy, dev)[..., None]
    vdd = f32(vdd, dev)
    sig_u = sig_rel_at_vdd(f32(lib.sig_u_rel, dev), vdd)[..., None]
    sig_n = sig_rel_at_vdd(f32(lib.sig_nand_rel, dev), vdd)[..., None]
    planes = _bit_planes(bits, dev)
    pow2 = _pow2(bits, dev)
    var_active = fp.fsum(planes * pow2[None, :]) * sig_u ** 2 / r
    n_byp = fp.fsum(1.0 - planes)
    var_bypass = n_byp * (sig_n / r) ** 2
    var_x1 = var_active + var_bypass                   # (*S, 2^B)
    var_x0 = (bits * (sig_n / r) ** 2).expand(var_x1.shape)
    return torch.stack([var_x0, var_x1], dim=-2)


def input_distribution(bits: int, p_x_one=C.P_X_ONE,
                       w_bit_sparsity=C.W_BIT_SPARSITY
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """(P(x), P(w)) for x in {0,1} and w in [0, 2^B): independent weight
    bits that are one with prob (1 - sparsity).  Batched inputs of shape S
    give shapes (*S, 2) and (*S, 2^B)."""
    dev = device_of(p_x_one, w_bit_sparsity)
    p1 = f32(p_x_one, dev)
    p_x = torch.stack([1.0 - p1, p1], dim=-1)
    planes = _bit_planes(bits, dev)
    p_one = 1.0 - f32(w_bit_sparsity, dev)[..., None, None]
    p_w = fp.fprod(planes * p_one + (1 - planes) * (1 - p_one))
    return p_x, p_w


def cell_energy_per_mac(bits: int, redundancy, vdd=C.VDD_NOM,
                        p_x_one=C.P_X_ONE,
                        w_bit_sparsity=C.W_BIT_SPARSITY,
                        lib: TechLib = DEFAULT_LIB) -> torch.Tensor:
    """E_cell of Eq. 7: expected energy of one 1xB TD MAC-OP; shape S for
    batched inputs broadcasting to S."""
    dev = device_of(redundancy, vdd, p_x_one, w_bit_sparsity)
    r = f32(redundancy, dev)[..., None]
    vdd = f32(vdd, dev)
    e_and = energy_at_vdd(f32(lib.e_td_and, dev), vdd)[..., None]
    e_nand = energy_at_vdd(f32(lib.e_td_nand, dev), vdd)[..., None]
    p_act = (f32(p_x_one, dev)
             * (1.0 - f32(w_bit_sparsity, dev)))[..., None]
    pow2 = _pow2(bits, dev)
    e_bit = p_act * r * pow2 * e_and + (1 - p_act) * e_nand
    return fp.fsum(e_bit) * (1.0 + lib.leakage_fraction)


def tdmac_area(bits: int, redundancy) -> torch.Tensor:
    """Eq. 14: A = (9*B + 7*R*sum_{i=0..B} 2^i) * CPP * H_cell, elementwise
    in R."""
    n_pitch = 9.0 * bits \
        + 7.0 * f32(redundancy) * (2.0 ** (bits + 1) - 1.0)
    return n_pitch * C.AREA_PER_PITCH
