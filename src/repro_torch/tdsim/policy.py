"""Per-layer execution policy for the TD-simulated matmul (port of
`repro/tdsim/policy.py`).

Couples the ML side to the hardware model: given the weight bit width, the
hardware chain length and an output error budget (sigma_max, in output-LSB
units), solves the redundancy factor R and TDC coarsening q exactly like
`core.design_space.evaluate_td`, and records the resulting per-chain noise
sigma that the simulator must inject.

`solve_td_policies` batch-solves every layer of a network in one call per
weight bit width; `solve_td_policy` is a thin wrapper over it.  The solves
and the supply argmin route through the process-wide `core.explorer`
service, so re-resolving the same network is a memo lookup.
`solve_network_policies` takes a per-layer sigma_array_max vector to one
`NetworkPolicy`; `apply_scenario` resolves each layer's operating point
for a named scenario / technology corner (`core.scenario`): the corner
derates the error budget, shifts the supply grid and resolves the
technology library, and the layer's Vdd is the grid argmin at that
library.

Every solve takes ``device=None``: where a memo miss sweeps (None = the
explorer service's device, CUDA unless the service was built for the
CPU).
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from repro_torch.core import chain as chain_mod
from repro_torch.core import constants as C
from repro_torch.core import explorer as explorer_mod
from repro_torch.core import scenario as scenario_mod
from repro_torch.core.techlib import TechLib


@dataclasses.dataclass(frozen=True)
class TDPolicy:
    """Static (hashable) execution policy of one matmul."""
    mode: str = "precise"        # "precise" | "quant" | "td"
    bits_a: int = 4              # activation bits (bit-serial planes)
    bits_w: int = 4              # weight bits (in-cell)
    n_chain: int = C.N_BASELINE  # hardware chain length (contraction tile)
    redundancy: int = 1          # R
    sigma_chain: float = 0.0     # injected per-chain noise std (LSB units)
    tdc_q: int = 1               # TDC LSB coarsening factor
    m: int = C.M_DEFAULT         # delay-line parallelism the solve assumed
    tdc_arch: str = "hybrid"     # TDC architecture the solve assumed
    vdd: float = C.VDD_NOM       # operating supply the (R, q) solve assumed
    p_x_one: float = C.P_X_ONE   # activation bit density the solve assumed
    w_bit_sparsity: float = C.W_BIT_SPARSITY  # weight bit sparsity assumed
    sigma_max: float | None = None   # error budget the solve ran at
    techlib: TechLib | None = None   # technology library (None = default)

    def replace(self, **kw) -> "TDPolicy":
        return dataclasses.replace(self, **kw)


PRECISE = TDPolicy(mode="precise")


@dataclasses.dataclass(frozen=True)
class TDLayerSpec:
    """One matmul's hardware question: (B_w, N, sigma_max, Vdd, input
    stats) -> policy.

    sigma_max=None means the exact regime (3 sigma <= 0.5): the returned
    policy still injects the residual sigma_chain -- the point of the paper's
    threshold is that this residual is harmless after rounding.  The input
    statistics default to the paper's Section IV constants; scenario
    resolution overrides them so the (R, q) solve runs under the same
    workload model that picked the supply.  `techlib` pins the technology
    library the solve runs against (None = default; scenario resolution
    sets the corner-resolved library here).
    """
    bits_a: int = 4
    bits_w: int = 4
    n_chain: int = C.N_BASELINE
    sigma_max: float | None = None
    vdd: float = C.VDD_NOM
    p_x_one: float = C.P_X_ONE
    w_bit_sparsity: float = C.W_BIT_SPARSITY
    m: int = C.M_DEFAULT
    tdc_arch: str = "hybrid"
    techlib: TechLib | None = None


def quant_policy(bits_a: int = 4, bits_w: int = 4) -> TDPolicy:
    return TDPolicy(mode="quant", bits_a=bits_a, bits_w=bits_w)


def solve_td_policies(specs: Sequence[TDLayerSpec],
                      device=None) -> list[TDPolicy]:
    """Solve (R, q, sigma_chain) for every layer of a network in one batched
    call per distinct weight bit width (the joint (R, q) solution is
    identical to design_space.evaluate_td)."""
    specs = list(specs)
    order: dict[tuple, list[int]] = {}
    for i, sp in enumerate(specs):
        order.setdefault((sp.bits_w, sp.m, sp.tdc_arch, sp.techlib),
                         []).append(i)
    out: list[TDPolicy | None] = [None] * len(specs)
    for (bits_w, m, tdc_arch, lib), idxs in order.items():
        n = np.array([specs[i].n_chain for i in idxs], np.float64)
        sig = np.array([chain_mod.sigma_max_exact()
                        if specs[i].sigma_max is None else specs[i].sigma_max
                        for i in idxs], np.float64)
        vdd = np.array([specs[i].vdd for i in idxs], np.float64)
        p1 = np.array([specs[i].p_x_one for i in idxs], np.float64)
        wsp = np.array([specs[i].w_bit_sparsity for i in idxs], np.float64)
        res = explorer_mod.service().evaluate_td(
            n, sig, vdd, bits=bits_w, m=m, tdc_arch=tdc_arch,
            p_x_one=p1, w_bit_sparsity=wsp, lib=lib, device=device)
        for k, i in enumerate(idxs):
            sp = specs[i]
            out[i] = TDPolicy(
                mode="td", bits_a=sp.bits_a, bits_w=sp.bits_w,
                n_chain=sp.n_chain,
                redundancy=int(res["redundancy"][k]),
                sigma_chain=float(res["sigma_chain_achieved"][k]),
                tdc_q=int(res["tdc_q"][k]),
                m=sp.m, tdc_arch=sp.tdc_arch,
                vdd=float(vdd[k]),
                p_x_one=float(p1[k]),
                w_bit_sparsity=float(wsp[k]),
                sigma_max=sp.sigma_max,
                techlib=sp.techlib)
    return out  # type: ignore[return-value]


def solve_td_policies_over_vdd(specs: Sequence[TDLayerSpec],
                               vdds: Sequence[float] | None = None,
                               device=None) -> list[TDPolicy]:
    """Supply-spanning batch solve: pick each layer's energy-minimizing
    Vdd from the grid at ITS OWN input statistics, then solve
    (R, q, sigma_chain) at the chosen supply.

    Where `solve_td_policies` keeps each spec's declared ``vdd`` fixed,
    this routine first runs the scenario grid's Vdd argmin
    (`optimal_td_vdds`, memoized in the explorer service) at the spec's
    (p_x_one, w_bit_sparsity).  ``vdds`` defaults to the paper's supply
    grid.
    """
    specs = list(specs)
    grid = tuple(scenario_mod.PAPER_VDD_GRID if vdds is None else
                 (float(v) for v in vdds))
    order: dict[tuple, list[int]] = {}
    for i, sp in enumerate(specs):
        order.setdefault((sp.bits_w, sp.m, sp.tdc_arch, sp.techlib,
                          round(float(sp.p_x_one), 9),
                          round(float(sp.w_bit_sparsity), 9)),
                         []).append(i)
    resolved: list[TDLayerSpec | None] = [None] * len(specs)
    for (bits_w, m, tdc_arch, lib, p1, wsp), idxs in order.items():
        sig = [chain_mod.sigma_max_exact() if specs[i].sigma_max is None
               else float(specs[i].sigma_max) for i in idxs]
        v = explorer_mod.service().optimal_td_vdds(
            [specs[i].n_chain for i in idxs], sig,
            bits=bits_w, vdds=grid, m=m, tdc_arch=tdc_arch,
            p_x_one=p1, w_bit_sparsity=wsp, lib=lib, device=device)
        for k, i in enumerate(idxs):
            resolved[i] = dataclasses.replace(specs[i], vdd=float(v[k]))
    return solve_td_policies(resolved, device)  # type: ignore[arg-type]


def apply_scenario(specs: Sequence[TDLayerSpec],
                   scenario, corner=None,
                   minimize_vdd: bool = True,
                   device=None) -> list[TDLayerSpec]:
    """Resolve each layer spec's operating point for a scenario/corner.

    The corner derates every error budget (an exact-regime layer derates
    from sigma_max_exact), shifts the scenario's supply grid and resolves
    the technology library the solve runs against (`Corner.apply_lib` of
    the scenario's base library); with `minimize_vdd` each layer's supply
    is the energy-minimizing grid point from one batched
    `optimal_td_vdds` call per distinct weight bit width -- evaluated at
    that same corner library -- otherwise the corner-shifted nominal
    supply is used.  The scenario's leading activity/sparsity entries set
    the input statistics of the argmin."""
    sc = scenario_mod.get_scenario(scenario)
    co = scenario_mod.get_corner(corner)
    vdd_grid = co.apply_vdds(sc.vdds)
    lib = co.apply_lib(sc.techlib)
    specs = list(specs)
    # exact-regime layers derate from the explicit exact budget
    sig_eff = [co.apply_sigmas((chain_mod.sigma_max_exact()
                                if sp.sigma_max is None
                                else sp.sigma_max,))[0]
               for sp in specs]
    if minimize_vdd:
        vdds = np.empty(len(specs), np.float64)
        order: dict[int, list[int]] = {}
        for i, sp in enumerate(specs):
            order.setdefault(sp.bits_w, []).append(i)
        for bits_w, idxs in order.items():
            v = explorer_mod.service().optimal_td_vdds(
                [specs[i].n_chain for i in idxs],
                [sig_eff[i] for i in idxs],
                bits=bits_w, vdds=vdd_grid, m=sc.m,
                tdc_arch=sc.tdc_archs[0],
                p_x_one=sc.p_x_ones[0],
                w_bit_sparsity=sc.w_bit_sparsities[0],
                lib=lib, device=device)
            vdds[idxs] = v
    else:
        vdds = np.asarray(co.apply_vdds([sp.vdd for sp in specs]))
    # the final (R, q, sigma_chain) solve must run under the same workload
    # model the supply argmin assumed: input statistics, chain count m,
    # TDC architecture AND the corner's technology library
    return [dataclasses.replace(sp, sigma_max=float(sig_eff[i]),
                                vdd=float(vdds[i]),
                                p_x_one=float(sc.p_x_ones[0]),
                                w_bit_sparsity=float(sc.w_bit_sparsities[0]),
                                m=int(sc.m), tdc_arch=str(sc.tdc_archs[0]),
                                techlib=lib)
            for i, sp in enumerate(specs)]


@dataclasses.dataclass(frozen=True)
class NetworkPolicy:
    """Heterogeneous per-layer execution policy of a whole network:
    `layers[i]` drives layer i, `top` the shared top-level matmuls
    (lm_head), `attn` per-head attention-engine policies (None = precise
    fused attention)."""
    layers: tuple[TDPolicy, ...]
    top: TDPolicy = PRECISE
    attn: tuple[TDPolicy, ...] | None = None

    def at(self, i: int) -> TDPolicy:
        return self.layers[i]

    def __len__(self) -> int:
        return len(self.layers)

    @property
    def homogeneous(self) -> bool:
        """True when every layer runs the same policy; a policy with a
        tensor-valued field counts as heterogeneous, as in the reference."""
        for p in self.layers:
            for f in dataclasses.fields(p):
                if isinstance(getattr(p, f.name), torch.Tensor):
                    return False
        return all(p == self.layers[0] for p in self.layers)


def pol_at(pol, i: int) -> TDPolicy:
    """Layer-i view of a policy."""
    return pol.at(i) if isinstance(pol, NetworkPolicy) else pol


def pol_top(pol) -> TDPolicy:
    """Policy of the shared top-level matmuls (lm_head)."""
    return pol.top if isinstance(pol, NetworkPolicy) else pol


def pol_attn(pol) -> tuple[TDPolicy, ...] | None:
    """Per-head attention-engine policies (None = precise fused kernels)."""
    return pol.attn if isinstance(pol, NetworkPolicy) else None


def solve_network_policies(sigma_max, *, bits_a=4, bits_w=4,
                           n_chain=C.N_BASELINE, vdd=C.VDD_NOM,
                           top: TDPolicy = PRECISE,
                           scenario=None, corner=None,
                           minimize_vdd: bool = True,
                           device=None) -> NetworkPolicy:
    """Per-layer sigma_array_max vector (Fig. 10) -> NetworkPolicy (Fig. 11).

    `sigma_max` is a per-layer (L,) budget vector (entries of None/NaN mean
    the exact regime for that layer); `bits_a`, `bits_w`, `n_chain` and
    `vdd` broadcast scalar-or-(L,).  All layers solve through
    `design_grid.evaluate_td_batched` in one batched call per distinct
    weight bit width.

    With `scenario` (a name from `core.scenario.SCENARIOS` or a Scenario)
    each layer resolves for that scenario/`corner`: the corner derates the
    budgets and shifts the supply grid, and `minimize_vdd` picks each
    layer's energy-minimizing supply by grid argmin (`apply_scenario`).
    """
    sig = np.asarray([np.nan if s is None else float(s) for s in
                      np.atleast_1d(np.asarray(sigma_max, object))],
                     np.float64)
    n_layers = len(sig)

    def bcast(v):
        return [x.item() for x in np.broadcast_to(np.asarray(v), (n_layers,))]

    ba, bw = bcast(bits_a), bcast(bits_w)
    nc, vd = bcast(n_chain), bcast(vdd)
    specs = [TDLayerSpec(bits_a=int(ba[i]), bits_w=int(bw[i]),
                         n_chain=int(nc[i]),
                         sigma_max=None if np.isnan(sig[i]) else sig[i],
                         vdd=float(vd[i]))
             for i in range(n_layers)]
    if scenario is not None:
        specs = apply_scenario(specs, scenario, corner, minimize_vdd, device)
    return NetworkPolicy(layers=tuple(solve_td_policies(specs, device)),
                         top=top)


def solve_td_policy(bits_a: int = 4, bits_w: int = 4,
                    n_chain: int = C.N_BASELINE,
                    sigma_max: float | None = None,
                    vdd: float = C.VDD_NOM, device=None) -> TDPolicy:
    """Single-layer wrapper over the batched solver."""
    return solve_td_policies([TDLayerSpec(bits_a, bits_w, n_chain, sigma_max,
                                          vdd)], device)[0]
