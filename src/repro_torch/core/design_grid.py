"""Batched three-domain design-space engine (port of
`repro/core/design_grid.py`: vectorized Figs. 9, 11, 12).

`sweep_batched` evaluates the full (domain x N x B x sigma_max x Vdd x
p_x_one x w_bit_sparsity x m x tdc_arch) grid on one device and returns a
structure-of-arrays `DesignGrid` on the host.  It is the only evaluation
path: the size-1 `design_space.evaluate_*` wrappers call the elementwise
entries below.  Every per-point loop is a batched axis:

  * the q (TDC LSB coarsening) candidate loop      -> a leading q axis +
                                                      argmin
  * the integer R refinement loop                  -> closed form + monotone
                                                      correction (core.chain)
  * the L_osc refinement loop                      -> dyadic-block candidate
                                                      argmin (core.tdc)
  * the (N, sigma, Vdd, activity, sparsity) grid   -> flattened point axis
  * the Vdd optimization loop                      -> `minimize_over_vdd`
  * the delay-line parallelism m and the TDC
    architecture (counter-hybrid vs SAR)           -> unrolled trailing axes
                                                      with `minimize_over_m`
                                                      / `minimize_over_tdc_arch`

The sweep (`_sweep`) is plain torch on an explicit device: float32 point
tensors of shape (P,) in, the domains, bit widths, m and TDC architectures
unrolled in Python as the reference unrolls them at trace time, a dict of
(D, NB, Nm, Nt, P) field tensors out, moved to the host once.  The engine's
float32 arithmetic gives the same bits on the CPU and the card
(`core.fp`), so a card sweep and a CPU sweep make the same integer
decisions.  Entry points take ``device=None``, which means CUDA.

Device tables come from a `core.techlib.TechLib` (``lib=``).  Pareto
frontiers, domain crossovers and winner intervals are host-side numpy
queries over the grid arrays, copied from the reference.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, Sequence

import numpy as np
import torch

from repro_torch import device as device_mod
from repro_torch.core import analog, cells, chain, digital, fp, tdc
from repro_torch.core import constants as C
from repro_torch.core.cells import f32
from repro_torch.core.techlib import TechLib, get_techlib

DOMAINS: tuple[str, ...] = ("td", "analog", "digital")
TDC_ARCHS: tuple[str, ...] = ("hybrid", "sar")

_FIELDS = ("e_mac", "throughput", "area_per_mac", "redundancy", "tdc_q",
           "l_osc", "sigma_chain", "latency")

# grid axis order of every DesignGrid field array
_AXES = ("domain", "bits", "n", "sigma", "vdd", "p_x_one", "w_bit_sparsity",
         "m", "tdc_arch")


# ---------------------------------------------------------------------------
# Per-domain batched evaluators over a flat point axis
# ---------------------------------------------------------------------------
def _eval_td_b(n, sigma, vdd, p_x_one, w_bit_sparsity, *, bits, m, q_max,
               clip_range, tdc_arch, lib: TechLib) -> dict:
    """TD evaluation of flat (P,) float32 point tensors with the (R, q)
    co-solution.

    Every q in [1, q_max] is evaluated on a leading axis, infeasible ones
    masked to +inf, argmin picks the winner (first occurrence == smallest
    q)."""
    dev = n.device
    sig2 = sigma ** 2
    qq = torch.arange(1, q_max + 1, dtype=torch.float32, device=dev)  # (Q,)
    quant_var = (qq ** 2 - 1.0) / 12.0
    # q=1 is always kept: it is the scalar path's fallback candidate
    feasible = (quant_var[:, None] < sig2[None, :] * 0.999) \
        | (qq[:, None] == 1.0)                              # (Q, P)
    sigma_chain = fp.sqrt(torch.clamp(sig2[None, :] - quant_var[:, None],
                                      min=1e-12))
    r = chain.solve_redundancy(n[None, :], bits, sigma_chain, vdd[None, :],
                               p_x_one=p_x_one[None, :],
                               w_bit_sparsity=w_bit_sparsity[None, :],
                               lib=lib)
    rf = r.to(torch.float32)
    e_cell = cells.cell_energy_per_mac(bits, rf, vdd[None, :],
                                       p_x_one[None, :],
                                       w_bit_sparsity[None, :], lib)
    steps = tdc.effective_range_steps(n, bits, clip_range)  # (P,)
    units = steps[None, :] * rf / qq[:, None]
    if tdc_arch == "hybrid":
        l_osc = tdc.optimal_l_osc(units, m, vdd[None, :], lib)
        e_tdc = tdc.hybrid_tdc_energy(units, l_osc, m, vdd[None, :], lib)
        t_tdc = tdc.hybrid_tdc_latency(units, l_osc, vdd[None, :], lib)
        a_tdc = tdc.hybrid_tdc_area(units, torch.clamp(l_osc, min=1.0), m)
    else:
        l_osc = torch.zeros_like(units)
        b_tdc = tdc.range_bits(steps[None, :] / qq[:, None])
        e_tdc = tdc.sar_tdc_energy(b_tdc, m, vdd[None, :], lib)
        t_tdc = tdc.sar_tdc_latency(b_tdc, vdd[None, :], lib)
        a_tdc = tdc.sar_tdc_area(b_tdc) * torch.ones_like(units)
    e_mac = e_cell + e_tdc / n[None, :]                     # Eq. 7
    tau = cells.delay_at_vdd(f32(lib.tau_unit, dev), vdd)   # (P,)
    t_chain = (steps[None, :] * rf + n[None, :] * bits) * tau[None, :]
    latency = t_chain + t_tdc
    throughput = n[None, :] * m / latency
    area = cells.tdmac_area(bits, rf) + a_tdc / n[None, :]
    qi = torch.argmin(torch.where(feasible, e_mac,
                                  torch.full_like(e_mac, torch.inf)),
                      dim=0)                                # (P,)

    def take(arr):
        return torch.gather(arr, 0, qi[None, :])[0]

    # e_cell/e_tdc ride along for the scalar wrappers' aux decomposition
    # (Eq. 7 check); _sweep keeps only _FIELDS.
    return {"e_mac": take(e_mac), "throughput": take(throughput),
            "area_per_mac": take(area), "redundancy": take(rf),
            "tdc_q": qq[qi], "l_osc": take(l_osc),
            "sigma_chain": take(sigma_chain), "latency": take(latency),
            "e_cell": take(e_cell), "e_tdc": take(e_tdc)}


def _eval_analog_b(n, sigma, vdd, p_x_one, w_bit_sparsity, *, bits, m,
                   clip_range, lib: TechLib) -> dict:
    res = analog.analog_energy_per_mac(n, bits, sigma, m, vdd, clip_range,
                                       p_x_one=p_x_one,
                                       w_bit_sparsity=w_bit_sparsity,
                                       lib=lib)
    thr = analog.analog_throughput(n, bits, sigma, m, clip_range, lib)
    area = analog.analog_area(n, bits, sigma, m, clip_range, lib)
    rate = analog.adc_rate(res["enob"], lib)
    one = torch.ones_like(n)
    return {"e_mac": res["e_mac"] * one, "throughput": thr * one,
            "area_per_mac": area * one,
            "redundancy": res["r"].to(torch.float32) * one,
            "tdc_q": one, "l_osc": 0.0 * one, "sigma_chain": 0.0 * one,
            "latency": 1.0 / rate * one,
            "enob": res["enob"] * one, "e_adc": res["e_adc"] * one,
            "e_cap": res["e_cap"] * one}


def _eval_digital_b(n, sigma, vdd, p_x_one, w_bit_sparsity, *, bits,
                    m, lib: TechLib) -> dict:
    e = digital.digital_energy_per_mac(n, bits, vdd, p_x_one=p_x_one,
                                       w_bit_sparsity=w_bit_sparsity,
                                       lib=lib)
    thr = digital.digital_throughput(n, bits, m, lib)
    area = digital.digital_area(n, bits, lib)
    one = torch.ones_like(n)
    return {"e_mac": e * one, "throughput": thr * one,
            "area_per_mac": area * one, "redundancy": one, "tdc_q": one,
            "l_osc": 0.0 * one, "sigma_chain": 0.0 * one,
            "latency": (1.0 / lib.f_dig) * one}


def _eval_domain_b(domain: str, n, sigma, vdd, p1, wsp, *, bits, m, q_max,
                   clip_range, tdc_arch, lib: TechLib) -> dict:
    if domain == "td":
        return _eval_td_b(n, sigma, vdd, p1, wsp, bits=bits, m=m,
                          q_max=q_max, clip_range=clip_range,
                          tdc_arch=tdc_arch, lib=lib)
    if domain == "analog":
        return _eval_analog_b(n, sigma, vdd, p1, wsp, bits=bits, m=m,
                              clip_range=clip_range, lib=lib)
    if domain == "digital":
        return _eval_digital_b(n, sigma, vdd, p1, wsp, bits=bits, m=m,
                               lib=lib)
    raise ValueError(f"unknown domain {domain!r}")


@torch.inference_mode()
def _sweep(n, sigma, vdd, p1, wsp, *, domains, bit_widths, ms, tdc_archs,
           q_max, clip_range, lib) -> torch.Tensor:
    """The whole grid on the points' device: flat (P,) float32 point
    tensors in, one (F, D, NB, Nm, Nt, P) tensor of the `_FIELDS` out.
    domains/bit_widths/ms/tdc_archs unroll here (table shapes depend on B;
    m and the TDC architecture select periphery structure).  Only the TD
    domain depends on tdc_arch -- analog/digital evaluate once per (B, m)
    and broadcast along the tdc_arch axis."""
    per_domain = []
    for d in domains:
        per_b = []
        for b in bit_widths:
            per_m = []
            for m in ms:
                if d == "td":
                    per_t = [_eval_domain_b(d, n, sigma, vdd, p1, wsp,
                                            bits=b, m=m, q_max=q_max,
                                            clip_range=clip_range,
                                            tdc_arch=t, lib=lib)
                             for t in tdc_archs]
                else:
                    one = _eval_domain_b(d, n, sigma, vdd, p1, wsp, bits=b,
                                         m=m, q_max=q_max,
                                         clip_range=clip_range,
                                         tdc_arch=tdc_archs[0], lib=lib)
                    per_t = [one] * len(tdc_archs)
                per_m.append(torch.stack([torch.stack([pt[f] for pt in
                                                       per_t])
                                          for f in _FIELDS]))
            per_b.append(torch.stack(per_m, dim=1))
        per_domain.append(torch.stack(per_b, dim=1))
    return torch.stack(per_domain, dim=1)


@torch.inference_mode()
def _eval_points(n, sigma, vdd, p1, wsp, *, domain, bits, m, q_max,
                 clip_range, tdc_arch, lib) -> dict:
    out = _eval_domain_b(domain, n, sigma, vdd, p1, wsp, bits=bits, m=m,
                         q_max=q_max, clip_range=clip_range,
                         tdc_arch=tdc_arch, lib=lib)
    if domain == "td":
        out["sigma_chain_achieved"] = chain.chain_sigma(
            n, bits, out["redundancy"], vdd, p1, wsp, lib)
    return out


def _q_ceiling(sigma_max: np.ndarray, relax_tdc: bool) -> int:
    """The q axis's ceiling from the largest budget; the per-point
    feasibility mask reproduces the retired scalar candidate enumeration
    exactly."""
    if not relax_tdc:
        return 1
    return int(np.floor(np.sqrt(12.0 * 0.999 * float(np.max(sigma_max)) ** 2
                                + 1.0))) + 1


def _points(arrays, dev) -> list[torch.Tensor]:
    """Flat float32 point tensors on ``dev`` from float64 numpy arrays (one
    host-to-device copy)."""
    flat = np.stack([np.asarray(a, np.float64).ravel() for a in arrays])
    return list(torch.from_numpy(flat.astype(np.float32)).to(dev))


def evaluate_points(domain: str, n, sigma_max, vdd=C.VDD_NOM, *, bits: int,
                    m: int = C.M_DEFAULT, clip_range: bool = True,
                    tdc_arch: str = "hybrid", relax_tdc: bool = True,
                    p_x_one=C.P_X_ONE,
                    w_bit_sparsity=C.W_BIT_SPARSITY,
                    lib: TechLib | str | None = None,
                    device=None) -> dict:
    """Elementwise evaluation of same-length point arrays (no grid product)
    for one domain, on ``device`` (None = CUDA).  All of (n, sigma_max,
    vdd, p_x_one, w_bit_sparsity) broadcast together.  Returns a dict of
    float64 numpy arrays keyed like _FIELDS plus domain extras (td:
    e_cell/e_tdc/sigma_chain_achieved; analog: enob/e_adc/e_cap)."""
    dev = device_mod.resolve(device)
    n_a, s_a, v_a, p_a, w_a = np.broadcast_arrays(
        np.asarray(n, np.float64), np.asarray(sigma_max, np.float64),
        np.asarray(vdd, np.float64), np.asarray(p_x_one, np.float64),
        np.asarray(w_bit_sparsity, np.float64))
    # q_max only shapes the TD q axis
    q_max = _q_ceiling(s_a, relax_tdc) if domain == "td" else 1
    out = _eval_points(*_points((n_a, s_a, v_a, p_a, w_a), dev),
                       domain=str(domain), bits=int(bits), m=int(m),
                       q_max=q_max, clip_range=bool(clip_range),
                       tdc_arch=str(tdc_arch), lib=get_techlib(lib))
    keys = list(out)
    host = torch.stack([out[k].to(torch.float32) for k in keys]).cpu()
    return {k: host[i].numpy().astype(np.float64).reshape(n_a.shape)
            for i, k in enumerate(keys)}


def evaluate_td_batched(n, sigma_max, vdd=C.VDD_NOM, *, bits: int,
                        m: int = C.M_DEFAULT, clip_range: bool = True,
                        tdc_arch: str = "hybrid", relax_tdc: bool = True,
                        p_x_one=C.P_X_ONE,
                        w_bit_sparsity=C.W_BIT_SPARSITY,
                        lib: TechLib | str | None = None,
                        device=None) -> dict:
    """TD evaluation of same-length point arrays: one call solving (R, q)
    for every point (the batch entry `tdsim.policy` solves a network's
    layers through).  Returns a dict of numpy arrays keyed like _FIELDS
    plus `sigma_chain_achieved` (= sqrt(N var_cell(R)), the noise the
    simulator must inject) and the e_cell/e_tdc split."""
    return evaluate_points("td", n, sigma_max, vdd, bits=bits, m=m,
                           clip_range=clip_range, tdc_arch=tdc_arch,
                           relax_tdc=relax_tdc, p_x_one=p_x_one,
                           w_bit_sparsity=w_bit_sparsity, lib=lib,
                           device=device)


# ---------------------------------------------------------------------------
# Structure-of-arrays result
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class DesignGrid:
    """Dense (domain x B x N x sigma x Vdd x p_x_one x w_bit_sparsity x m x
    tdc_arch) design grid, SoA layout.

    Field arrays have shape (D, NB, Nn, Ns, Nv, Na, Nw, Nm, Nt) and
    float64-safe numpy dtypes; `redundancy` and `tdc_q` are
    integral-valued.  A grid produced by a `minimize_over_*` reduction has
    a length-1 reduced axis with the per-point winning value recorded in
    `vdd_opt` / `m_opt` / `tdc_arch_opt` (the reduced axis labels become
    [nan] / [-1] / ("opt",) respectively).
    """
    domains: tuple[str, ...]
    ns: np.ndarray
    bit_widths: np.ndarray
    sigma_maxes: np.ndarray
    vdds: np.ndarray
    p_x_ones: np.ndarray
    w_bit_sparsities: np.ndarray
    ms: np.ndarray
    tdc_archs: tuple[str, ...]
    e_mac: np.ndarray
    throughput: np.ndarray
    area_per_mac: np.ndarray
    redundancy: np.ndarray
    tdc_q: np.ndarray
    l_osc: np.ndarray
    sigma_chain: np.ndarray
    latency: np.ndarray
    # per-point optimal values after minimize_over_* reductions
    vdd_opt: np.ndarray | None = None
    m_opt: np.ndarray | None = None
    tdc_arch_opt: np.ndarray | None = None

    @property
    def shape(self) -> tuple[int, ...]:
        return self.e_mac.shape

    @property
    def n_points(self) -> int:
        return int(np.prod(self.shape))

    @property
    def m(self) -> int:
        """Single-valued m axis as a scalar (legacy accessor; raises on a
        swept or reduced m axis — use `ms`/`point_m` there)."""
        if len(self.ms) != 1 or int(self.ms[0]) < 0:
            raise ValueError("grid sweeps m; use .ms or .point_m(ix)")
        return int(self.ms[0])

    def domain_index(self, domain: str) -> int:
        return self.domains.index(domain)

    def winners(self, metric: str = "e_mac") -> np.ndarray:
        """(NB, Nn, Ns, Nv, Na, Nw, Nm, Nt) int array of the winning domain
        index."""
        arr = getattr(self, metric)
        return (np.argmax(arr, axis=0) if metric == "throughput"
                else np.argmin(arr, axis=0))

    def winner_names(self, metric: str = "e_mac") -> np.ndarray:
        return np.asarray(self.domains)[self.winners(metric)]

    def point_vdd(self, ix: tuple) -> float:
        """Supply voltage of one grid point (honours vdd_opt reductions)."""
        if self.vdd_opt is not None:
            return float(self.vdd_opt[ix])
        return float(self.vdds[ix[4]])

    def point_m(self, ix: tuple) -> int:
        """Delay-line parallelism of one grid point (honours m_opt)."""
        if self.m_opt is not None:
            return int(self.m_opt[ix])
        return int(self.ms[ix[7]])

    def point_tdc_arch(self, ix: tuple) -> str:
        """TDC architecture of one grid point (honours tdc_arch_opt)."""
        if self.tdc_arch_opt is not None:
            return str(self.tdc_arch_opt[ix])
        return self.tdc_archs[ix[8]]

    def records(self) -> Iterable[dict]:
        """Flat per-point dict rows (CSV/JSON friendly), row-major over
        (domain, bits, n, sigma, vdd, p_x_one, w_bit_sparsity, m,
        tdc_arch)."""
        for ix in np.ndindex(*self.shape):
            di, bi, ni, si, vi, ai, wi, mi, ti = ix
            yield {
                "domain": self.domains[di], "n": int(self.ns[ni]),
                "bits": int(self.bit_widths[bi]),
                "sigma_max": float(self.sigma_maxes[si]),
                "vdd": self.point_vdd(ix),
                "p_x_one": float(self.p_x_ones[ai]),
                "w_bit_sparsity": float(self.w_bit_sparsities[wi]),
                "m": self.point_m(ix),
                "tdc_arch": self.point_tdc_arch(ix),
                "e_mac": float(self.e_mac[ix]),
                "throughput": float(self.throughput[ix]),
                "area_per_mac": float(self.area_per_mac[ix]),
                "redundancy": int(self.redundancy[ix]),
                "tdc_q": int(self.tdc_q[ix]),
                "latency": float(self.latency[ix]),
            }

    def save_npz(self, path: str) -> str:
        """Persist the full grid (axes + SoA fields) as one compressed .npz
        -- the practical format at 10^5+ points (to_json was retired with
        the scalar path)."""
        payload = {
            "domains": np.asarray(self.domains),
            "ns": self.ns, "bit_widths": self.bit_widths,
            "sigma_maxes": self.sigma_maxes, "vdds": self.vdds,
            "p_x_ones": self.p_x_ones,
            "w_bit_sparsities": self.w_bit_sparsities,
            "ms": self.ms, "tdc_archs": np.asarray(self.tdc_archs),
        }
        for f in _FIELDS:
            payload[f] = getattr(self, f)
        for opt in ("vdd_opt", "m_opt", "tdc_arch_opt"):
            v = getattr(self, opt)
            if v is not None:
                payload[opt] = v
        np.savez_compressed(path, **payload)
        return path

    @classmethod
    def load_npz(cls, path: str) -> "DesignGrid":
        with np.load(path, allow_pickle=False) as z:
            # pre-m/tdc_arch archives stored a scalar "m" and 7-axis
            # fields: migrate by expanding the two trailing length-1 axes
            legacy = "ms" not in z

            def field(a: np.ndarray) -> np.ndarray:
                return a[..., None, None] if legacy else a

            fields = {f: field(z[f]) for f in _FIELDS}
            opts = {opt: field(z[opt]) if opt in z else None
                    for opt in ("vdd_opt", "m_opt", "tdc_arch_opt")}
            ms = (np.atleast_1d(np.asarray(z["m"], np.int64)) if legacy
                  else z["ms"])
            archs = (("hybrid",) if legacy
                     else tuple(str(t) for t in z["tdc_archs"]))
            return cls(domains=tuple(str(d) for d in z["domains"]),
                       ns=z["ns"], bit_widths=z["bit_widths"],
                       sigma_maxes=z["sigma_maxes"], vdds=z["vdds"],
                       p_x_ones=z["p_x_ones"],
                       w_bit_sparsities=z["w_bit_sparsities"],
                       ms=ms, tdc_archs=archs,
                       **opts, **fields)


def sweep_batched(domains: Sequence[str] = DOMAINS,
                  ns: Sequence[int] = (16, 32, 64, 128, 256, 576, 1024,
                                       2048, 4096),
                  bit_widths: Sequence[int] = (1, 2, 4, 8),
                  sigma_maxes: Sequence[float] | float | None = None,
                  vdds: Sequence[float] | float = C.VDD_NOM,
                  p_x_ones: Sequence[float] | float = C.P_X_ONE,
                  w_bit_sparsities: Sequence[float] | float
                  = C.W_BIT_SPARSITY,
                  m: Sequence[int] | int = C.M_DEFAULT,
                  clip_range: bool = True,
                  tdc_arch: Sequence[str] | str = "hybrid",
                  relax_tdc: bool = True,
                  lib: TechLib | str | None = None,
                  device=None) -> DesignGrid:
    """Evaluate the full (domain x N x B x sigma x Vdd x p_x_one x
    w_bit_sparsity x m x tdc_arch) grid on ``device`` (None = CUDA).
    sigma_maxes=None means the exact regime of Fig. 9.  `m` and `tdc_arch`
    accept a scalar or a sequence (a swept trailing axis)."""
    dev = device_mod.resolve(device)
    if sigma_maxes is None:
        sigma_maxes = chain.sigma_max_exact()
    sig = np.atleast_1d(np.asarray(sigma_maxes, np.float64))
    vdd = np.atleast_1d(np.asarray(vdds, np.float64))
    p1 = np.atleast_1d(np.asarray(p_x_ones, np.float64))
    wsp = np.atleast_1d(np.asarray(w_bit_sparsities, np.float64))
    ns_a = np.atleast_1d(np.asarray(ns, np.int64))
    ms = tuple(int(v) for v in np.atleast_1d(np.asarray(m, np.int64)))
    archs = ((tdc_arch,) if isinstance(tdc_arch, str)
             else tuple(str(t) for t in tdc_arch))
    for t in archs:
        if t not in TDC_ARCHS:
            raise ValueError(f"unknown TDC arch {t!r} (have {TDC_ARCHS})")
    grids = np.meshgrid(ns_a, sig, vdd, p1, wsp, indexing="ij")
    out = _sweep(*_points(grids, dev),
                 domains=tuple(domains), bit_widths=tuple(bit_widths),
                 ms=ms, tdc_archs=archs, q_max=_q_ceiling(sig, relax_tdc),
                 clip_range=bool(clip_range), lib=get_techlib(lib))
    host = out.cpu().numpy()          # the sweep's one device-to-host copy
    # (F, D, NB, Nm, Nt, P): expand P and move (m, tdc_arch) to the
    # trailing axes of the public layout
    pre = (len(domains), len(bit_widths), len(ms), len(archs),
           len(ns_a), len(sig), len(vdd), len(p1), len(wsp))
    fields = {f: np.moveaxis(host[i].astype(np.float64).reshape(pre),
                             (2, 3), (7, 8))
              for i, f in enumerate(_FIELDS)}
    fields["redundancy"] = np.rint(fields["redundancy"]).astype(np.int64)
    fields["tdc_q"] = np.rint(fields["tdc_q"]).astype(np.int64)
    return DesignGrid(domains=tuple(domains), ns=ns_a,
                      bit_widths=np.asarray(bit_widths, np.int64),
                      sigma_maxes=sig, vdds=vdd, p_x_ones=p1,
                      w_bit_sparsities=wsp,
                      ms=np.asarray(ms, np.int64), tdc_archs=archs,
                      **fields)


# ---------------------------------------------------------------------------
# Grid merging: refinement sweeps concatenate along one traced point axis
# ---------------------------------------------------------------------------
# traced point axes a refinement can densify, and the DesignGrid attribute
# holding that axis's values
_POINT_AXES = {"n": "ns", "sigma": "sigma_maxes", "vdd": "vdds",
               "p_x_one": "p_x_ones", "w_bit_sparsity": "w_bit_sparsities"}


def concat_along_axis(grids: Sequence["DesignGrid"],
                      axis_name: str) -> "DesignGrid":
    """Merge same-shaped grids that differ only in their `axis_name` values
    into ONE grid whose axis is the sorted union (duplicates dropped, first
    occurrence kept).

    This is how the incremental-refinement recursion (`core.explorer`)
    folds each level's dense re-sweep back into the working grid: the
    merged axis is generally NON-uniform (coarse points plus dense argmin
    neighborhoods).  Only raw sweeps merge -- grids that already carry a
    `minimize_over_*` reduction must be reduced AFTER merging (the argmin
    over a partial axis is not the argmin over the union)."""
    if axis_name not in _POINT_AXES:
        raise ValueError(f"cannot concat along {axis_name!r} "
                         f"(point axes: {sorted(_POINT_AXES)})")
    grids = list(grids)
    if not grids:
        raise ValueError("need at least one grid")
    attr = _POINT_AXES[axis_name]
    axis = _AXES.index(axis_name)
    first = grids[0]
    for g in grids:
        for opt in _OPT_FIELDS:
            if getattr(g, opt) is not None:
                raise ValueError(
                    f"cannot concat a grid reduced over {opt[:-4]!r}: merge "
                    "raw sweeps first, reduce the merged grid")
        if (g.domains != first.domains or g.tdc_archs != first.tdc_archs
                or not all(np.array_equal(getattr(g, a), getattr(first, a))
                           for a in _POINT_AXES.values() if a != attr)
                or not np.array_equal(g.bit_widths, first.bit_widths)
                or not np.array_equal(g.ms, first.ms)):
            raise ValueError("grids differ on a non-concatenated axis")
    vals = np.concatenate([getattr(g, attr) for g in grids])
    _, keep = np.unique(vals, return_index=True)   # sorted unique positions
    fields = {f: np.take(np.concatenate([getattr(g, f) for g in grids],
                                        axis=axis), keep, axis=axis)
              for f in _FIELDS}
    return dataclasses.replace(first, **{attr: vals[keep]}, **fields)


# ---------------------------------------------------------------------------
# Grid reductions: Vdd / m / tdc_arch as minimized-over axes
# ---------------------------------------------------------------------------
_VDD_AXIS = _AXES.index("vdd")
_M_AXIS = _AXES.index("m")
_TDC_AXIS = _AXES.index("tdc_arch")

_OPT_FIELDS = ("vdd_opt", "m_opt", "tdc_arch_opt")


def _minimize_axis(grid: DesignGrid, axis_name: str,
                   metric: str = "e_mac") -> DesignGrid:
    """Shared argmin reduction: collapse one grid axis to each
    domain-point's optimum of `metric` (argmax for throughput), recording
    the winning axis value per point.  First occurrence wins ties, exactly
    like the retired `td_vdd_optimized` python loop's strict <."""
    axis = _AXES.index(axis_name)
    arr = getattr(grid, metric)
    pick = np.argmax if metric == "throughput" else np.argmin
    idx = pick(arr, axis=axis)
    idx_e = np.expand_dims(idx, axis)
    fields = {f: np.take_along_axis(getattr(grid, f), idx_e, axis=axis)
              for f in _FIELDS}
    # carry every already-recorded per-point optimum through the reduction
    opts = {o: np.take_along_axis(getattr(grid, o), idx_e, axis=axis)
            for o in _OPT_FIELDS if getattr(grid, o) is not None}
    if axis_name == "vdd":
        if "vdd_opt" not in opts:          # first reduction of this axis
            opts["vdd_opt"] = grid.vdds[idx_e]
        axes_repl = {"vdds": np.asarray([np.nan])}
    elif axis_name == "m":
        if "m_opt" not in opts:
            opts["m_opt"] = grid.ms[idx_e]
        axes_repl = {"ms": np.asarray([-1], np.int64)}
    elif axis_name == "tdc_arch":
        if "tdc_arch_opt" not in opts:
            opts["tdc_arch_opt"] = np.asarray(grid.tdc_archs)[idx_e]
        axes_repl = {"tdc_archs": ("opt",)}
    else:
        raise ValueError(f"cannot minimize over axis {axis_name!r} "
                         "(reducible axes: vdd, m, tdc_arch)")
    return dataclasses.replace(grid, **axes_repl, **opts, **fields)


def minimize_over_vdd(grid: DesignGrid, metric: str = "e_mac") -> DesignGrid:
    """Reduce the Vdd axis to each domain-point's optimal supply (argmin of
    `metric`; argmax for throughput), recording the winning Vdd per point in
    `vdd_opt`.  Returns a grid with a length-1 Vdd axis (`vdds == [nan]`:
    the supply is per-point now)."""
    return _minimize_axis(grid, "vdd", metric)


def minimize_over_m(grid: DesignGrid, metric: str = "e_mac") -> DesignGrid:
    """Reduce the delay-line-parallelism axis to each point's optimal m
    (recorded per point in `m_opt`; the m axis label becomes [-1])."""
    return _minimize_axis(grid, "m", metric)


def minimize_over_tdc_arch(grid: DesignGrid,
                           metric: str = "e_mac") -> DesignGrid:
    """Reduce the TDC-architecture axis to each point's optimal converter
    (recorded per point in `tdc_arch_opt`; the axis label becomes
    ("opt",))."""
    return _minimize_axis(grid, "tdc_arch", metric)


# ---------------------------------------------------------------------------
# Queries: Pareto frontier and domain-crossover boundaries
# ---------------------------------------------------------------------------
def pareto_mask(costs: np.ndarray, chunk: int = 256) -> np.ndarray:
    """Boolean mask of non-dominated rows of `costs` (P, K), lower-better.

    A point is dominated if another point is <= on every objective and
    strictly < on at least one.  Exact at any size via the lexicographically
    sorted archive sweep: a dominator is <= everywhere and < somewhere, so
    its first differing objective is strictly smaller and it sorts
    *strictly before* the dominated point in lexicographic row order (pure
    comparisons -- no float summation that could round ties away).  A point
    can therefore only be dominated by points before it, and (dominance
    being transitive) checking against the non-dominated archive plus the
    point's own block suffices.  O(P * (F + chunk)) with F the frontier
    size, instead of the naive O(P^2).  The result is independent of
    `chunk` (property-tested, including the P % chunk == 0 +- 1
    boundaries)."""
    costs = np.asarray(costs, np.float64)
    p, k = costs.shape
    if p == 0:
        return np.zeros(0, bool)
    # lexsort keys: last key is primary -> reverse so column 0 leads
    order = np.lexsort(costs.T[::-1])
    sc = costs[order]                                      # (P, K), lex asc
    keep_sorted = np.empty(p, bool)
    archive = np.empty((0, k), np.float64)
    for lo in range(0, p, chunk):
        blk = sc[lo:lo + chunk]                            # (b, K)
        # vs the non-dominated archive (all sort lex-before this block, so
        # they are the only candidates that can dominate it)
        le = (archive[None, :, :] <= blk[:, None, :]).all(-1)   # (b, F)
        lt = (archive[None, :, :] < blk[:, None, :]).any(-1)
        alive = ~(le & lt).any(-1)
        # intra-block pairwise (self never dominates self: no strict <);
        # a block dominator that is itself dominated is covered by
        # transitivity through the archive
        le = (blk[None, :, :] <= blk[:, None, :]).all(-1)       # (b, b)
        lt = (blk[None, :, :] < blk[:, None, :]).any(-1)
        alive &= ~(le & lt).any(-1)
        keep_sorted[lo:lo + chunk] = alive
        archive = np.concatenate([archive, blk[alive]])
    keep = np.empty(p, bool)
    keep[order] = keep_sorted
    return keep


def pareto_frontier(grid: DesignGrid,
                    objectives: Sequence[str] = ("e_mac", "area_per_mac",
                                                 "throughput")) -> np.ndarray:
    """Non-dominated mask over all grid points, shaped like grid.e_mac.

    `throughput` is maximized, every other objective minimized."""
    cols = []
    for name in objectives:
        col = getattr(grid, name).ravel().astype(np.float64)
        cols.append(-col if name == "throughput" else col)
    return pareto_mask(np.stack(cols, axis=-1)).reshape(grid.shape)


def _point_keys(grid: DesignGrid, di, bi, ni, si, vi, ai, wi, mi,
                ti) -> dict:
    """Axis keys of one (domain, point): the per-point optimum (vdd_opt /
    m_opt / tdc_arch_opt of domain `di`) on reduced axes, the axis label
    otherwise -- query records never carry the [-1]/"opt"/nan reduction
    sentinels."""
    ix = (di, bi, ni, si, vi, ai, wi, mi, ti)
    return {
        "bits": int(grid.bit_widths[bi]),
        "sigma_max": float(grid.sigma_maxes[si]),
        "vdd": grid.point_vdd(ix),
        "p_x_one": float(grid.p_x_ones[ai]),
        "w_bit_sparsity": float(grid.w_bit_sparsities[wi]),
        "m": grid.point_m(ix),
        "tdc_arch": grid.point_tdc_arch(ix),
    }


def domain_crossovers(grid: DesignGrid,
                      metric: str = "e_mac") -> list[dict]:
    """Where the winning domain flips along the N axis -- the paper's
    "TD wins for small-to-medium N" boundary as a queryable result.

    One record per (bits, sigma, vdd, activity, sparsity, m, tdc_arch,
    consecutive-N pair) with a change."""
    w = grid.winners(metric)              # (NB, Nn, Ns, Nv, Na, Nw, Nm, Nt)
    flips = w[:, 1:] != w[:, :-1]
    out = []
    for bi, ni, si, vi, ai, wi, mi, ti in np.argwhere(flips):
        rec = {"metric": metric}
        # key the record at the low side's winning domain (reduced-axis
        # optima are per (domain, point))
        di_low = int(w[bi, ni, si, vi, ai, wi, mi, ti])
        rec.update(_point_keys(grid, di_low, bi, ni, si, vi, ai, wi, mi,
                               ti))
        rec.update({
            "n_low": int(grid.ns[ni]),
            "n_high": int(grid.ns[ni + 1]),
            "domain_low": grid.domains[w[bi, ni, si, vi, ai, wi, mi, ti]],
            "domain_high":
                grid.domains[w[bi, ni + 1, si, vi, ai, wi, mi, ti]],
        })
        out.append(rec)
    return out


def winner_intervals(grid: DesignGrid, domain: str = "td",
                     metric: str = "e_mac") -> list[dict]:
    """Per (bits, sigma, vdd, activity, sparsity, m, tdc_arch): the
    [n_min, n_max] span where `domain` wins (empty span -> record omitted).
    Spans need not be contiguous; this reports the hull plus the win
    count."""
    di = grid.domain_index(domain)
    w = grid.winners(metric) == di        # (NB, Nn, Ns, Nv, Na, Nw, Nm, Nt)
    out = []
    nb, _, ns_, nv, na, nw, nm, nt = w.shape
    for bi, si, vi, ai, wi, mi, ti in np.ndindex(nb, ns_, nv, na, nw,
                                                 nm, nt):
        hits = np.flatnonzero(w[bi, :, si, vi, ai, wi, mi, ti])
        if hits.size == 0:
            continue
        rec = {"domain": domain, "metric": metric}
        # key at the queried domain's first winning N
        rec.update(_point_keys(grid, di, bi, int(hits[0]), si, vi, ai, wi,
                               mi, ti))
        rec.update({"n_min": int(grid.ns[hits[0]]),
                    "n_max": int(grid.ns[hits[-1]]),
                    "wins": int(hits.size)})
        out.append(rec)
    return out
