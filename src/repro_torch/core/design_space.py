"""Three-domain design-space comparison engine (port of
`repro/core/design_space.py`, paper Figs. 9, 11, 12).

For a VMM of chain length N, input width B, M parallel chains and an output
error budget sigma_max (in output-LSB units), evaluates energy/MAC,
throughput and area/MAC for:

  * "td"      -- time domain  (Eq. 7: E_cell + E_TDC/N, R from Eq. 5/6)
  * "analog"  -- charge domain (Eq. 11-13)
  * "digital" -- adder tree (exact by construction; sigma_max ignored)

The *exact* regime is sigma_max = ERR_EXACT_MAX / SIGMA_CONFIDENCE (Fig. 9),
the *relaxed* regime a sigma_array_max from the noise tolerance of a
quantized network (Fig. 10 -> Fig. 11).

The batched engine (`core.design_grid`) is the only evaluation path: the
`evaluate_*` entry points below are size-1 wrappers over its elementwise
evaluators, returning a `DesignPoint`.  `td_vdd_optimized` is an argmin
query over a Vdd grid axis (`design_grid.minimize_over_vdd`).  Every entry
point takes ``device=None``, which means CUDA.
"""
from __future__ import annotations

import dataclasses
from typing import Literal

from repro_torch.core import chain
from repro_torch.core import constants as C
from repro_torch.core.design_grid import (DesignGrid, domain_crossovers,
                                    evaluate_points, minimize_over_vdd,
                                    pareto_frontier, pareto_mask,
                                    sweep_batched, winner_intervals)
from repro_torch.core.scenario import PAPER_VDD_GRID

Domain = Literal["td", "analog", "digital"]
DOMAINS: tuple[Domain, ...] = ("td", "analog", "digital")

__all__ = ["DesignPoint", "DesignGrid", "DOMAINS", "evaluate", "evaluate_td",
           "evaluate_analog", "evaluate_digital", "sweep", "sweep_batched",
           "best_domain", "td_vdd_optimized", "sigma_exact",
           "pareto_frontier", "pareto_mask", "domain_crossovers",
           "winner_intervals", "minimize_over_vdd"]


@dataclasses.dataclass(frozen=True)
class DesignPoint:
    domain: str
    n: int                  # chain length
    bits: int               # input (weight) bit width B
    m: int                  # parallel chains
    sigma_max: float        # error budget, output-LSB units
    e_mac: float            # J / MAC-OP
    throughput: float       # MAC / s
    area_per_mac: float     # m^2 / MAC
    redundancy: int         # R (1 for digital)
    aux: dict


def _point(domain: str, res: dict, n: int, bits: int, m: int,
           sigma_max: float, aux: dict) -> DesignPoint:
    return DesignPoint(domain, n, bits, m, sigma_max,
                       float(res["e_mac"]), float(res["throughput"]),
                       float(res["area_per_mac"]),
                       int(round(float(res["redundancy"]))), aux)


def evaluate_td(n: int, bits: int, sigma_max: float, m: int = C.M_DEFAULT,
                vdd: float = C.VDD_NOM, clip_range: bool = True,
                tdc_arch: str = "hybrid", relax_tdc: bool = True,
                p_x_one: float = C.P_X_ONE,
                w_bit_sparsity: float = C.W_BIT_SPARSITY,
                lib=None, device=None) -> DesignPoint:
    """Size-1 wrapper over the batched TD evaluator: the (R, q) co-solution
    of Eq. 5-7 for one point (`lib` selects the technology library;
    `p_x_one`/`w_bit_sparsity` the input statistics the pricing assumes)."""
    res = evaluate_points("td", n, sigma_max, vdd, bits=bits, m=m,
                          clip_range=clip_range, tdc_arch=tdc_arch,
                          relax_tdc=relax_tdc, p_x_one=p_x_one,
                          w_bit_sparsity=w_bit_sparsity, lib=lib,
                          device=device)
    aux = {"e_cell": float(res["e_cell"]), "e_tdc": float(res["e_tdc"]),
           "l_osc": int(round(float(res["l_osc"]))),
           "latency": float(res["latency"]), "vdd": float(vdd),
           "tdc_lsb_q": int(round(float(res["tdc_q"]))),
           "sigma_chain_budget": float(res["sigma_chain"])}
    return _point("td", res, n, bits, m, sigma_max, aux)


def evaluate_analog(n: int, bits: int, sigma_max: float,
                    m: int = C.M_DEFAULT, vdd: float = C.VDD_NOM,
                    clip_range: bool = True,
                    p_x_one: float = C.P_X_ONE,
                    w_bit_sparsity: float = C.W_BIT_SPARSITY,
                    lib=None, device=None) -> DesignPoint:
    res = evaluate_points("analog", n, sigma_max, vdd, bits=bits, m=m,
                          clip_range=clip_range, p_x_one=p_x_one,
                          w_bit_sparsity=w_bit_sparsity, lib=lib,
                          device=device)
    aux = {"enob": float(res["enob"]), "e_adc": float(res["e_adc"]),
           "e_cap": float(res["e_cap"])}
    return _point("analog", res, n, bits, m, sigma_max, aux)


def evaluate_digital(n: int, bits: int, sigma_max: float = 0.0,
                     m: int = C.M_DEFAULT,
                     vdd: float = C.VDD_NOM,
                     p_x_one: float = C.P_X_ONE,
                     w_bit_sparsity: float = C.W_BIT_SPARSITY,
                     lib=None, device=None) -> DesignPoint:
    res = evaluate_points("digital", n, sigma_max, vdd, bits=bits, m=m,
                          p_x_one=p_x_one, w_bit_sparsity=w_bit_sparsity,
                          lib=lib, device=device)
    return _point("digital", res, n, bits, m, sigma_max, {})


_EVAL = {"td": evaluate_td, "analog": evaluate_analog,
         "digital": evaluate_digital}


def evaluate(domain: Domain, n: int, bits: int, sigma_max: float,
             m: int = C.M_DEFAULT, **kw) -> DesignPoint:
    if domain == "digital":
        kw.pop("clip_range", None)
        kw.pop("tdc_arch", None)
    return _EVAL[domain](n, bits, sigma_max, m, **kw)


def sigma_exact() -> float:
    return chain.sigma_max_exact()


def sweep(domains=DOMAINS,
          ns=(16, 32, 64, 128, 256, 576, 1024, 2048, 4096),
          bit_widths=(1, 2, 4, 8),
          sigma_max: float | None = None,
          m: int = C.M_DEFAULT, vdd: float = C.VDD_NOM,
          **kw) -> list[DesignPoint]:
    """Full (domain x N x B) grid at a single error budget, as a flat list
    of DesignPoints (one sweep_batched call underneath).
    sigma_max=None means the exact regime of Fig. 9."""
    s = sigma_exact() if sigma_max is None else sigma_max
    g = sweep_batched(domains=domains, ns=ns, bit_widths=bit_widths,
                      sigma_maxes=s, vdds=vdd, m=m, **kw)
    out = []
    for di, d in enumerate(g.domains):
        for ni in range(len(g.ns)):
            for bi in range(len(g.bit_widths)):
                ix = (di, bi, ni, 0, 0, 0, 0, 0, 0)
                res = {f: getattr(g, f)[ix]
                       for f in ("e_mac", "throughput", "area_per_mac",
                                 "redundancy")}
                aux = {"tdc_lsb_q": int(g.tdc_q[ix]),
                       "l_osc": int(round(float(g.l_osc[ix]))),
                       "latency": float(g.latency[ix])}
                out.append(_point(d, res, int(g.ns[ni]),
                                  int(g.bit_widths[bi]), g.m, s, aux))
    return out


def best_domain(n: int, bits: int, sigma_max: float,
                m: int = C.M_DEFAULT,
                metric: str = "e_mac", device=None) -> DesignPoint:
    """Winner (minimum e_mac / area, maximum throughput) at one point."""
    pts = [evaluate(d, n, bits, sigma_max, m, device=device)
           for d in DOMAINS]
    if metric == "throughput":
        return max(pts, key=lambda p: p.throughput)
    return min(pts, key=lambda p: getattr(p, metric))


def td_vdd_optimized(n: int, bits: int, sigma_max: float,
                     m: int = C.M_DEFAULT,
                     vdd_grid=PAPER_VDD_GRID, device=None) -> DesignPoint:
    """Beyond-paper knob: jointly pick (Vdd, R) for minimum TD energy.

    The paper notes TD's easy voltage scaling (design at nominal, scale down
    for error-tolerant workloads) but Fig. 11 relaxes only R.  Scaling Vdd
    degrades eta_ESNR, so R must grow; the optimum trades R * E_cell(V)
    against V^2.  Implemented as a grid argmin: Vdd is a minimized-over
    axis of the batched grid (`minimize_over_vdd`), not a python loop."""
    g = sweep_batched(domains=("td",), ns=(n,), bit_widths=(bits,),
                      sigma_maxes=sigma_max, vdds=vdd_grid, m=m,
                      device=device)
    red = minimize_over_vdd(g)
    v_star = float(red.vdd_opt[0, 0, 0, 0, 0, 0, 0, 0, 0])
    return evaluate_td(n, bits, sigma_max, m, vdd=v_star, device=device)
