"""Scenario engine (port of `repro/core/scenario.py`): named (Vdd x sigma
x activity x sparsity x m x tdc_arch) sweeps with technology-corner presets
on top of the batched design grid.

``Corner``
    A technology-corner preset: scenario-axis effects (``vdd_shift``,
    ``sigma_derate``) and device-table multipliers applied to the base
    `core.techlib.TechLib` through `TechLib.at_corner`.

``Scenario``
    A frozen spec of the grid axes to sweep (``sigma_maxes=None`` is the
    exact regime), the base library name ``techlib`` and the corners.

``sweep_scenario`` / ``sweep_scenarios``
    One corner of a scenario (or every corner, one after another) as one
    grid sweep per corner against that corner's library, optionally
    reduced over the ``vdd``/``m``/``tdc_arch`` axes.

``optimal_td_vdds``
    The per-layer supply query `tdsim.policy` resolves network policies
    through.

Registries `SCENARIOS` / `CORNERS` back the launchers' `--scenario` /
`--corner` flags.  Sweeps take ``device=None``, which means CUDA.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from repro_torch.core import constants as C
from repro_torch.core import chain, design_grid
from repro_torch.core.techlib import TechLib, get_techlib

__all__ = ["Corner", "Scenario", "CORNERS", "SCENARIOS", "get_corner",
           "get_scenario", "sweep_scenario", "sweep_scenarios",
           "optimal_td_vdds", "PAPER_VDD_GRID"]

# The beyond-paper Vdd-optimization grid (kept identical to the retired
# td_vdd_optimized python loop so the grid argmin reproduces it exactly;
# order matters: first minimum wins ties like the loop's strict <).
PAPER_VDD_GRID = (0.80, 0.72, 0.65, 0.58, 0.52, 0.46, 0.40)


# ---------------------------------------------------------------------------
# Technology corners
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class Corner:
    """Process-corner preset: scenario-axis effects + device-table
    multipliers.

    A slow (SS) corner raises the effective threshold -- at a given supply
    the delay cells see less overdrive (modelled as a negative supply
    shift), systematic variation eats part of the error budget (sigma
    derate < 1), and the device tables themselves degrade: slower cells,
    higher switching energy and higher mismatch, though *less* subthreshold
    leakage (higher Vth -- the same coupling as the HVT-like `22fdx-lp`
    library flavor).  Fast (FF) is the mirror image: faster, lower-energy,
    tighter-mismatch cells that leak more (the ``*_mult`` fields, applied
    through `TechLib.at_corner`).  TT is the identity: a TT sweep is
    bit-identical to a plain `sweep_batched` over the same axes and the
    default library.
    """
    name: str
    vdd_shift: float = 0.0        # V, added to every grid supply
    sigma_derate: float = 1.0     # multiplies the error budget
    # device-table multipliers (TechLib.at_corner); 1.0 = untouched
    cell_delay_mult: float = 1.0      # delay-cell / unit-cell delays
    cell_energy_mult: float = 1.0     # cell + TDC periphery energies
    mismatch_mult: float = 1.0        # delay mismatch sigmas + INL
    cap_mismatch_mult: float = 1.0    # analog unit-cap mismatch
    digital_energy_mult: float = 1.0  # adder-tree synthesis energies
    leakage_mult: float = 1.0         # static-energy fraction

    def apply_vdds(self, vdds: Sequence[float]) -> tuple[float, ...]:
        """Shifted supplies, floored at VDD_MIN (the lowest modelled
        supply: below it the alpha-power mismatch model diverges)."""
        return tuple(float(max(v + self.vdd_shift, C.VDD_MIN))
                     for v in np.atleast_1d(np.asarray(vdds, np.float64)))

    def apply_sigmas(self, sigma_maxes) -> tuple[float, ...] | None:
        if sigma_maxes is None:
            if self.sigma_derate == 1.0:
                return None
            sigma_maxes = (chain.sigma_max_exact(),)
        return tuple(float(s * self.sigma_derate)
                     for s in np.atleast_1d(np.asarray(sigma_maxes,
                                                       np.float64)))

    def apply_lib(self, lib: TechLib | str | None = None) -> TechLib:
        """The corner's technology library: base tables with this corner's
        multipliers applied (the identity corner returns the base library
        unchanged -- bit-identical sweeps)."""
        return get_techlib(lib).at_corner(self)


CORNERS: dict[str, Corner] = {
    "tt": Corner("tt"),
    "ff": Corner("ff", vdd_shift=+0.04, sigma_derate=1.00,
                 cell_delay_mult=0.90, cell_energy_mult=0.96,
                 mismatch_mult=0.88, cap_mismatch_mult=0.92,
                 digital_energy_mult=0.96, leakage_mult=1.50),
    "ss": Corner("ss", vdd_shift=-0.04, sigma_derate=0.90,
                 cell_delay_mult=1.12, cell_energy_mult=1.05,
                 mismatch_mult=1.15, cap_mismatch_mult=1.10,
                 digital_energy_mult=1.05, leakage_mult=0.70),
}


def get_corner(corner: str | Corner | None) -> Corner:
    if corner is None:
        return CORNERS["tt"]
    if isinstance(corner, Corner):
        return corner
    try:
        return CORNERS[corner]
    except KeyError:
        raise ValueError(f"unknown corner {corner!r} "
                         f"(have {sorted(CORNERS)})") from None


# ---------------------------------------------------------------------------
# Scenario specs
# ---------------------------------------------------------------------------
_DEF_NS = (16, 32, 64, 128, 256, 576, 1024, 2048, 4096)


@dataclasses.dataclass(frozen=True)
class Scenario:
    """A named design-space scenario: the grid axes plus corner presets.

    All axes are tuples (hashable: a Scenario is a valid frozen-config
    field).  `sigma_maxes=None` is the exact regime;
    ``ms``/``tdc_archs`` are the trailing static-unrolled axes of the grid
    (single-valued by default); ``techlib`` names the base library the
    corners perturb (`core.techlib.TECHLIBS`)."""
    name: str
    ns: tuple[int, ...] = _DEF_NS
    bit_widths: tuple[int, ...] = (1, 2, 4, 8)
    sigma_maxes: tuple[float, ...] | None = (2.0,)
    vdds: tuple[float, ...] = PAPER_VDD_GRID
    p_x_ones: tuple[float, ...] = (C.P_X_ONE,)
    w_bit_sparsities: tuple[float, ...] = (C.W_BIT_SPARSITY,)
    ms: tuple[int, ...] = (C.M_DEFAULT,)
    tdc_archs: tuple[str, ...] = ("hybrid",)
    corners: tuple[str, ...] = ("tt",)
    techlib: str = "22fdx"

    @property
    def m(self) -> int:
        """Leading m entry (the policy-resolution operating point)."""
        return self.ms[0]

    def replace(self, **kw) -> "Scenario":
        return dataclasses.replace(self, **kw)


def _lin(lo: float, hi: float, n: int) -> tuple[float, ...]:
    return tuple(float(v) for v in np.round(np.linspace(lo, hi, n), 4))


SCENARIOS: dict[str, Scenario] = {
    # the paper's Figs. 9/11 grids at nominal supply
    "paper-exact": Scenario("paper-exact", sigma_maxes=None,
                            vdds=(C.VDD_NOM,)),
    "paper-relaxed": Scenario("paper-relaxed", sigma_maxes=(2.0,),
                              vdds=(C.VDD_NOM,)),
    # beyond-paper: joint (Vdd, R) optimization over the retired loop's grid
    "vdd-opt": Scenario("vdd-opt", sigma_maxes=(2.0,)),
    # error-tolerant edge workload: scaled supplies, relaxed budgets,
    # activity/sparsity spread, all corners
    "edge": Scenario("edge",
                     ns=(16, 32, 64, 128, 256, 576, 1024),
                     bit_widths=(2, 4),
                     sigma_maxes=(0.5, 1.0, 2.0, 4.0),
                     vdds=_lin(0.40, 0.80, 9),
                     p_x_ones=(0.3, 0.5),
                     w_bit_sparsities=(0.5, 0.7, 0.9),
                     corners=("tt", "ff", "ss")),
    # periphery co-design: m and the TDC architecture as swept axes, so the
    # winner maps expose the paper's Fig. 7 SAR-vs-hybrid boundary and the
    # periphery-sharing sweet spot per corner
    "periphery": Scenario("periphery",
                          ns=(16, 64, 256, 576, 1024, 4096),
                          bit_widths=(2, 4),
                          sigma_maxes=(0.5, 2.0),
                          vdds=(0.60, C.VDD_NOM),
                          ms=(2, 4, 8, 16, 32),
                          tdc_archs=("hybrid", "sar"),
                          corners=("tt", "ff", "ss")),
    # the dense winner-map sweep (>= 1e5 points per corner in one sweep)
    "dense": Scenario("dense",
                      ns=tuple(int(x) for x in np.unique(np.round(
                          np.geomspace(16, 4096, 24)).astype(int))),
                      bit_widths=(1, 2, 4, 8),
                      sigma_maxes=(0.25, 0.5, 1.0, 2.0, 4.0),
                      vdds=_lin(0.40, 0.80, 12),
                      p_x_ones=(0.3, 0.5),
                      w_bit_sparsities=(0.5, 0.7, 0.9),
                      ms=(8, 16),
                      tdc_archs=("hybrid", "sar"),
                      corners=("tt", "ff", "ss")),
}


def get_scenario(scenario: str | Scenario) -> Scenario:
    if isinstance(scenario, Scenario):
        return scenario
    try:
        return SCENARIOS[scenario]
    except KeyError:
        raise ValueError(f"unknown scenario {scenario!r} "
                         f"(have {sorted(SCENARIOS)})") from None


# ---------------------------------------------------------------------------
# Sweeps
# ---------------------------------------------------------------------------
_REDUCERS = {
    "vdd": design_grid.minimize_over_vdd,
    "m": design_grid.minimize_over_m,
    "tdc_arch": design_grid.minimize_over_tdc_arch,
}


def _reduce(grid: design_grid.DesignGrid,
            minimize_over: Sequence[str]) -> design_grid.DesignGrid:
    for axis in minimize_over:
        try:
            grid = _REDUCERS[axis](grid)
        except KeyError:
            raise ValueError(
                f"cannot minimize over axis {axis!r} "
                f"(reducible axes: {sorted(_REDUCERS)})") from None
    return grid


def sweep_scenario(scenario: str | Scenario,
                   corner: str | Corner | None = None,
                   minimize_over: Sequence[str] = (),
                   device=None) -> design_grid.DesignGrid:
    """One corner of a scenario as one grid sweep against the corner's
    resolved technology library (plus the optional numpy-side argmin
    reductions)."""
    sc = get_scenario(scenario)
    co = get_corner(corner)
    grid = design_grid.sweep_batched(
        ns=sc.ns, bit_widths=sc.bit_widths,
        sigma_maxes=co.apply_sigmas(sc.sigma_maxes),
        vdds=co.apply_vdds(sc.vdds),
        p_x_ones=sc.p_x_ones, w_bit_sparsities=sc.w_bit_sparsities,
        m=sc.ms, tdc_arch=sc.tdc_archs,
        lib=co.apply_lib(sc.techlib), device=device)
    return _reduce(grid, minimize_over)


def sweep_scenarios(scenario: str | Scenario,
                    corners: Sequence[str | Corner] | None = None,
                    minimize_over: Sequence[str] = (),
                    device=None) -> dict[str, design_grid.DesignGrid]:
    """All corners of a scenario, one after another: {corner_name:
    DesignGrid}."""
    sc = get_scenario(scenario)
    cos = [get_corner(c) for c in (corners if corners is not None
                                   else sc.corners)]
    return {co.name: sweep_scenario(sc, co, minimize_over, device)
            for co in cos}


def optimal_td_vdds(n, sigma_max, *, bits: int,
                    vdds: Sequence[float] = PAPER_VDD_GRID,
                    m: int = C.M_DEFAULT,
                    tdc_arch: str = "hybrid",
                    p_x_one: float = C.P_X_ONE,
                    w_bit_sparsity: float = C.W_BIT_SPARSITY,
                    lib: TechLib | str | None = None,
                    device=None) -> np.ndarray:
    """Energy-minimizing TD supply per (n, sigma_max) point over a Vdd grid:
    one `evaluate_td_batched` call on the (points x Vdd) product, argmin
    along Vdd (first minimum wins, like the retired python loop).

    This is the scenario -> policy coupling: tdsim.policy feeds the layer
    vector through it to pick each layer's operating point (at the
    corner's library when `lib` is a corner-resolved TechLib)."""
    n_a = np.atleast_1d(np.asarray(n, np.float64))
    s_a = np.atleast_1d(np.asarray(sigma_max, np.float64))
    n_a, s_a = np.broadcast_arrays(n_a, s_a)
    v = np.asarray(list(vdds), np.float64)
    res = design_grid.evaluate_td_batched(
        n_a[..., None], s_a[..., None], v[None, :], bits=int(bits), m=int(m),
        tdc_arch=str(tdc_arch),
        p_x_one=float(p_x_one), w_bit_sparsity=float(w_bit_sparsity),
        lib=lib, device=device)
    return v[np.argmin(res["e_mac"], axis=-1)]
