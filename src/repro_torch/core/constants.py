"""Technology calibration constants for the three compute domains.

The paper feeds SPICE simulation results (22 nm FD-SOI, TT corner) into its
python framework.  This container has no SPICE, so the tables below are
*synthesized* — but every value is pinned by a quantitative anchor the paper
states explicitly:

  * tristate inverter has the best eta_ESNR across a wide voltage range (Fig. 3c)
  * TD-MAC INL peaks at +-0.11 delay steps for B=4, R=1 (Fig. 4b)
  * ADC envelope fit: k1 = 0.66 pJ, k2 = 0.241 aJ (Eq. 12, from [12] survey)
  * MOSCAP relative capacitance mismatch < 2.5 % (Section IV)
  * digital reference synthesized at 1 GHz, 22 nm, TT corner (Section IV)
  * weight bitwise sparsity 70 % (ResNet18 measurement, Section IV)
  * M = 8 parallel chains baseline (following [7])
  * baseline chain length N = 576 = 3*3*64 (ResNet18 kernel, Section III-A)

Comment convention (units audit): every constant is annotated
``# [unit] description (paper anchor)``.  ``[J]`` is Joules *per event*
(the event named in the description: transition, increment, MAC, ...),
``[steps]`` is the TD delay-step unit of the paper's error analysis
(err_chain <= 0.5 steps means half an output LSB), ``[rel]`` is a
dimensionless relative sigma, ``[-]`` a dimensionless factor.

These module constants are the *source values* only.  The physics modules
(`cells`/`chain`/`tdc`/`analog`/`digital`) never read the device tables
from here directly: they consume a `core.techlib.TechLib` (whose
``DEFAULT_LIB`` is built from these exact floats, so defaults are
bit-identical), which is what lets technology corners perturb the tables
themselves (`TechLib.at_corner`).  A CI grep enforces the indirection.
"""
from __future__ import annotations

import dataclasses

# ---------------------------------------------------------------------------
# Generic technology (GF 22FDX-class numbers)
# ---------------------------------------------------------------------------
VDD_NOM = 0.80          # [V] nominal supply (Section IV: 22 nm FD-SOI)
VDD_MIN = 0.40          # [V] lowest modelled supply (Fig. 3c sweep floor)
VTH_EFF = 0.35          # [V] effective threshold, alpha-power delay model
ALPHA_SAT = 1.30        # [-] alpha-power-law velocity-saturation exponent

CPP = 104e-9            # [m] contacted poly pitch (22FDX)
CELL_H = 1.17e-6        # [m] 8-track standard cell height
AREA_PER_PITCH = CPP * CELL_H   # [m^2] one transistor pitch (Eq. 14 unit)

# ---------------------------------------------------------------------------
# Delay-element library (Fig. 3b) -- per cell, at VDD_NOM
# Values chosen so the tristate inverter wins eta_ESNR (Fig. 3c ordering:
# tristate > delay-cell > inverter at nominal, gap widening at low VDD).
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class DelayCellSpec:
    name: str
    energy: float       # [J] per output transition, at VDD_NOM (Fig. 3b)
    delay: float        # [s] per stage, at VDD_NOM (Fig. 3b)
    sig_rel: float      # [rel] sigma(delay)/delay, local mismatch (Fig. 3b)
    n_transistors: int  # [-] transistor count, for area

DELAY_CELLS = {
    "inverter": DelayCellSpec("inverter", energy=1.00e-15, delay=12e-12,
                              sig_rel=0.040, n_transistors=2),
    "delay_cell": DelayCellSpec("delay_cell", energy=2.60e-15, delay=48e-12,
                                sig_rel=0.022, n_transistors=4),
    "tristate": DelayCellSpec("tristate", energy=1.30e-15, delay=30e-12,
                              sig_rel=0.025, n_transistors=4),
}

# TD-AND / TD-NAND building blocks of the baseline TD-MAC cell (Fig. 4a).
# Both are tristate-like (best eta_ESNR).  TD-NAND is the bypass path and is
# NOT replicated with R (single cell), TD-AND cascades are.
E_TD_AND = 1.00e-15     # [J] per transition, one TD-AND unit cell (Fig. 4a)
E_TD_NAND = 0.45e-15    # [J] per transition, TD-NAND bypass (min-size,
                        #     lightly loaded) (Fig. 4a)
TAU_UNIT = 30e-12       # [s] one unit-cell delay == one step at R=1 (Fig. 4a)
SIG_U_REL = 0.040       # [rel] mismatch sigma of one unit-cell delay (Eq. 6)
SIG_NAND_REL = 0.012    # [steps] bypass delay sigma, unit-cell delays (Eq. 6)
N_TRANS_TD_AND = 7      # [-] transistors per TD-AND subcell (Eq. 14: 7R term)
N_TRANS_TD_NAND = 9     # [-] transistors per TD-NAND bypass (Eq. 14: 9B term)

# INL of the TD-MAC cell comes from the TD-NAND(bypass)/TD-AND path delay
# discrepancy.  delta_nand is that discrepancy in delay-step units at R=1;
# it is fixed hardware, so in step units it scales as 1/R (paper Eq. 6).
# Calibrated so that max |INL| = 0.11 steps at B=4, R=1 (Fig. 4b).
DELTA_NAND_STEPS = 0.150    # [steps] INL per bypassed subcell (Fig. 4b cal)

# ---------------------------------------------------------------------------
# TDC periphery (Section III-A)
# ---------------------------------------------------------------------------
E_SAMPLE = 4.5e-15      # [J] one sampling-flipflop event (Eq. 8/10)
E_CNT = 200e-15         # [J] gray-counter increment incl. clock tree
                        #     (synthesis estimate; makes SAR win B=1, Fig. 7)
E_CNT_LOAD = 4.0e-15    # [J] driving one chain's MSB sample register (Eq. 8)
M_DEFAULT = 8           # [-] parallel compute chains sharing periphery ([7])

# ---------------------------------------------------------------------------
# Analog charge domain (Section IV, Eq. 11-13)
# ---------------------------------------------------------------------------
K1_ADC = 0.66e-12       # [J/ENOB] ADC envelope, linear term (Eq. 12, [12])
K2_ADC = 0.241e-18      # [J/4^ENOB] ADC envelope, exp term (Eq. 12, [12])
C_UNIT = 0.55e-15       # [F] unit MOSCAP of the charge-domain MAC (Fig. 8b)
SIG_CAP_REL = 0.025     # [rel] unit-capacitor mismatch (< 2.5 %, Section IV)
E_PASS_LOGIC = 0.05e-15 # [J] pass-transistor "AND" drive event (Fig. 8b)
F_ADC_BASE = 50e6       # [Hz] conversion-rate envelope @ low ENOB ([12])
F_ADC_DECAY = 0.5       # [-] envelope: f = F_ADC_BASE*2^(-decay*(ENOB-6))
ADC_AREA_BASE = 2.4e-9  # [m^2] smallest qualifying ADC (Section IV-A filter)
ADC_AREA_PER_ENOB = 1.45 # [-] area multiplier per extra ENOB (long-channel)

# ---------------------------------------------------------------------------
# Digital adder-tree reference (Section IV: post-layout, 1 GHz, TT)
#   Energy of a 1-by-B MAC inside an N-long single-cycle VMM array:
#     E = (alpha_sw * (B + log2(N)) * E_FA) + E_SEQ + E_WIRE(N)
#   alpha_sw folds in the 70 % weight bitwise sparsity.
# ---------------------------------------------------------------------------
E_FA_BIT = 1.9e-15      # [J] full-adder bit incl. local wiring (Section IV)
E_SEQ_MAC = 0.55e-15    # [J] clock/register overhead per MAC (Section IV)
E_WIRE_PER_LOG2N = 0.20e-15  # [J] global routing per tree level (Section IV)
E_AND_GATE_BIT = 0.35e-15    # [J] AND gating stage per weight bit (Sec. IV)
ALPHA_SW_DIGITAL = 0.24 # [-] switching activity @ 70 % weight-bit sparsity
F_DIG = 1.0e9           # [Hz] single-cycle VMM synthesis target (Section IV)
A_FA_BIT = 1.15e-12     # [m^2] one full-adder bit after P&R (Section IV)
A_SEQ_MAC = 0.70e-12    # [m^2] sequential/clock area per MAC (Section IV)

# ---------------------------------------------------------------------------
# Input statistics (Section IV)
# ---------------------------------------------------------------------------
P_X_ONE = 0.5           # [-] P(activation bit == 1), bit-serial activations
W_BIT_SPARSITY = 0.70   # [-] P(weight bit == 0): measured 60-80 %, use 70 %
N_BASELINE = 576        # [-] 3*3*64 ResNet18 conv chain length (Sec. III-A)
LEAKAGE_FRACTION = 0.06 # [-] static energy adder on all dynamic energies

# Effective output-range model (Fig. 6): CNN layer outputs concentrate, the
# usable TDC/ADC range is kappa * sqrt(N) * (2^B - 1) instead of N*(2^B-1).
RANGE_KAPPA = 2.0       # [-] observed-range concentration factor (Fig. 6)

# Accuracy regimes
ERR_EXACT_MAX = 0.5     # [steps] |err_chain| <= 0.5 LSB -> exact (Eq. 5)
SIGMA_CONFIDENCE = 3.0  # [-] err_chain <= 3 sigma assumption (Gaussian)
