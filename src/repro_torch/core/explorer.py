"""Design-space explorer service, the in-process part (port of
`repro/core/explorer.py`): an in-memory cache of sweep results and a memo
of point queries.

``ExplorerService``
    A long-lived service over the scenario engine.  It caches sweep
    results in memory (LRU), keyed on (TechLib content hash, corner-applied
    axis values, grid shape, minimize_over reductions, code-version salt),
    so a repeated or reduction-sliced query -- winner map, Pareto frontier,
    `minimize_over_*` argmin, policy resolve -- is a dictionary lookup.
    The point queries (`evaluate_td`, `optimal_td_vdds`) are memoized the
    same way and return copies.  Counters live in `ExplorerStats`.
    ``device`` (None = CUDA) is where a miss sweeps; a call may name
    another.

``service()`` / ``set_service()``
    The process-wide default instance; `tdsim.policy` routes every policy
    solve through it, so re-resolving a network is a memo lookup.

One lock (an RLock) guards the caches and the counters, so a staged
rebuild thread may solve through the service while the serve loop does;
`count_fallback` counts a remote resolve degraded to this process
(`launch.explore.resolve_with_fallback`).  The TCP front end is
`launch/explore.py`.  The reference's on-disk store (``cache_dir``),
incremental refinement (`refine`) and thread-pool corner fan-out are not
ported yet (ROADMAP §1, item 8): asking for them raises
`NotImplementedError`.
"""
from __future__ import annotations

import collections
import dataclasses
import functools
import hashlib
import inspect
import threading
import time
from typing import Sequence

import numpy as np

from repro_torch.core import chain, design_grid
from repro_torch.core import constants as C
from repro_torch.core import scenario as scenario_mod
from repro_torch.core.techlib import TechLib, get_techlib

__all__ = ["ExplorerService", "ExplorerStats", "service", "set_service",
           "grid_cache_key"]

_REDUCERS = {
    "vdd": design_grid.minimize_over_vdd,
    "m": design_grid.minimize_over_m,
    "tdc_arch": design_grid.minimize_over_tdc_arch,
}


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} of the explorer is not yet ported to repro_torch "
        "(ROADMAP.md §1, item 8)")


@functools.lru_cache(maxsize=1)
def _code_salt() -> str:
    """Digest of the port's evaluation-engine sources: any change to the
    physics or the grid engine changes every cache key."""
    from repro_torch.core import analog, cells, digital, fp, tdc, techlib
    h = hashlib.sha256(b"explorer-code-v1:repro_torch:")
    for mod in (design_grid, cells, chain, tdc, analog, digital, techlib, fp,
                C):
        h.update(inspect.getsource(mod).encode("utf-8"))
    return h.hexdigest()[:16]


def _fmt_floats(vals) -> str:
    return ",".join(float(v).hex() for v in vals)


def grid_cache_key(*, domains, bit_widths, ms, tdc_archs, clip_range,
                   relax_tdc, ns, sigma_maxes, vdds, p_x_ones,
                   w_bit_sparsities, lib: TechLib,
                   minimize_over=()) -> str:
    """Content key of one sweep, deterministic across processes: the code
    salt, the library's `content_hash`, the grid shape, every axis's exact
    float values (`float.hex`) and the reduction list."""
    parts = [
        "grid-v1", _code_salt(), lib.content_hash(),
        "domains=" + ",".join(domains),
        "bits=" + ",".join(str(int(b)) for b in bit_widths),
        "ms=" + ",".join(str(int(m)) for m in ms),
        "tdc=" + ",".join(tdc_archs),
        f"clip={bool(clip_range)}", f"relax={bool(relax_tdc)}",
        "ns=" + ",".join(str(int(n)) for n in ns),
        "sigma=" + _fmt_floats(sigma_maxes),
        "vdd=" + _fmt_floats(vdds),
        "px=" + _fmt_floats(p_x_ones),
        "wsp=" + _fmt_floats(w_bit_sparsities),
        "min=" + ",".join(minimize_over),
    ]
    return hashlib.sha256("|".join(parts).encode("ascii")).hexdigest()


@dataclasses.dataclass
class ExplorerStats:
    """Service counters (mutate in place, snapshot to read).

    ``points_evaluated`` counts grid points actually solved by the engine;
    ``points_served`` counts points returned to callers.  The reference's
    disk, refinement and fan-out counters stay 0 here."""
    queries: int = 0
    memory_hits: int = 0
    disk_hits: int = 0
    misses: int = 0
    evictions: int = 0
    points_evaluated: int = 0
    points_served: int = 0
    eval_seconds: float = 0.0
    td_queries: int = 0
    td_hits: int = 0
    vdd_opt_queries: int = 0
    vdd_opt_hits: int = 0
    refine_runs: int = 0
    refine_levels: int = 0
    fanout_sweeps: int = 0
    fallback_resolves: int = 0

    def snapshot(self) -> dict:
        return dataclasses.asdict(self)

    @property
    def hit_rate(self) -> float:
        return ((self.memory_hits + self.disk_hits) / self.queries
                if self.queries else 0.0)


class ExplorerService:
    """Long-lived design-space explorer (see module docstring)."""

    def __init__(self, cache_dir: str | None = None,
                 max_memory_entries: int = 64,
                 max_point_entries: int = 512, device=None):
        if cache_dir:
            raise _not_ported("the on-disk store (cache_dir)")
        self.cache_dir = None
        self.device = device
        self._grids: collections.OrderedDict[str, design_grid.DesignGrid] \
            = collections.OrderedDict()
        self._points: collections.OrderedDict[str, dict] \
            = collections.OrderedDict()
        self._max_grids = int(max_memory_entries)
        self._max_points = int(max_point_entries)
        self._lock = threading.RLock()
        self.stats = ExplorerStats()
        self.started_at = time.time()

    def _device(self, device):
        return self.device if device is None else device

    # -- cache plumbing ----------------------------------------------------
    @property
    def cache_entries(self) -> int:
        with self._lock:
            return len(self._grids)

    @property
    def cache_bytes(self) -> int:
        with self._lock:
            return sum(sum(getattr(g, f).nbytes for f in design_grid._FIELDS)
                       for g in self._grids.values())

    def clear(self) -> None:
        """Drop the in-memory caches."""
        with self._lock:
            self._grids.clear()
            self._points.clear()

    def count_fallback(self) -> int:
        """Record one remote resolve degraded to this process, under the
        service lock: a staged rebuild thread and the serve loop may both
        degrade at once, and ``stats.fallback_resolves += 1`` alone is a
        read-modify-write race.  Returns the new count."""
        with self._lock:
            self.stats.fallback_resolves += 1
            return self.stats.fallback_resolves

    def _grid_get(self, key: str) -> design_grid.DesignGrid | None:
        with self._lock:
            g = self._grids.get(key)
            if g is not None:
                self._grids.move_to_end(key)
            return g

    def _grid_put(self, key: str, g: design_grid.DesignGrid) -> None:
        with self._lock:
            self._grids[key] = g
            self._grids.move_to_end(key)
            while len(self._grids) > self._max_grids:
                self._grids.popitem(last=False)
                self.stats.evictions += 1

    # -- sweeps ------------------------------------------------------------
    @staticmethod
    def _normalize_axes(*, domains=design_grid.DOMAINS, ns, bit_widths,
                        sigma_maxes, vdds, p_x_ones, w_bit_sparsities,
                        ms, tdc_archs, clip_range=True, relax_tdc=True,
                        lib=None) -> dict:
        if sigma_maxes is None:
            sigma_maxes = (float(chain.sigma_max_exact()),)
        as_floats = lambda v: tuple(float(x) for x in np.atleast_1d(v))  # noqa: E731
        return dict(
            domains=tuple(domains),
            ns=tuple(int(n) for n in np.atleast_1d(ns)),
            bit_widths=tuple(int(b) for b in np.atleast_1d(bit_widths)),
            sigma_maxes=as_floats(sigma_maxes), vdds=as_floats(vdds),
            p_x_ones=as_floats(p_x_ones),
            w_bit_sparsities=as_floats(w_bit_sparsities),
            ms=tuple(int(m) for m in np.atleast_1d(ms)),
            tdc_archs=((tdc_archs,) if isinstance(tdc_archs, str)
                       else tuple(str(t) for t in tdc_archs)),
            clip_range=bool(clip_range), relax_tdc=bool(relax_tdc),
            lib=get_techlib(lib))

    def sweep_axes(self, minimize_over: Sequence[str] = (),
                   use_cache: bool = True, device=None,
                   **axes) -> design_grid.DesignGrid:
        return self.sweep_axes_info(minimize_over=minimize_over,
                                    use_cache=use_cache, device=device,
                                    **axes)[0]

    def sweep_axes_info(self, minimize_over: Sequence[str] = (),
                        use_cache: bool = True, device=None,
                        **axes) -> tuple[design_grid.DesignGrid, dict]:
        """One (possibly reduced) sweep through the cache.  Returns the
        grid plus an info dict: ``source`` in {memory, computed, bypass}
        and ``elapsed_ms``.  Cached grids are shared -- treat them as
        read-only."""
        ax = self._normalize_axes(**axes)
        minimize_over = tuple(minimize_over)
        key = grid_cache_key(**ax, minimize_over=minimize_over)
        t0 = time.perf_counter()
        with self._lock:
            self.stats.queries += 1
        g = self._grid_get(key) if use_cache else None
        source = "memory" if g is not None else "bypass"
        if g is None:
            g = design_grid.sweep_batched(
                domains=ax["domains"], ns=ax["ns"],
                bit_widths=ax["bit_widths"], sigma_maxes=ax["sigma_maxes"],
                vdds=ax["vdds"], p_x_ones=ax["p_x_ones"],
                w_bit_sparsities=ax["w_bit_sparsities"], m=ax["ms"],
                clip_range=ax["clip_range"], tdc_arch=ax["tdc_archs"],
                relax_tdc=ax["relax_tdc"], lib=ax["lib"],
                device=self._device(device))
            for axis in minimize_over:
                try:
                    g = _REDUCERS[axis](g)
                except KeyError:
                    raise ValueError(
                        f"cannot minimize over axis {axis!r} "
                        f"(reducible axes: {sorted(_REDUCERS)})") from None
            if use_cache:
                self._grid_put(key, g)
            source = "computed"
            with self._lock:
                self.stats.misses += 1
                self.stats.points_evaluated += g.n_points
        else:
            with self._lock:
                self.stats.memory_hits += 1
        elapsed = time.perf_counter() - t0
        with self._lock:
            self.stats.points_served += g.n_points
            self.stats.eval_seconds += elapsed
        return g, {"source": source, "elapsed_ms": elapsed * 1e3,
                   "key": key}

    @staticmethod
    def _corner_axes(sc_: scenario_mod.Scenario,
                     co: scenario_mod.Corner) -> dict:
        """Scenario axes after the corner's supply shift / budget derate,
        against the corner-resolved library -- exactly what
        `scenario.sweep_scenario` feeds `sweep_batched`."""
        return dict(ns=sc_.ns, bit_widths=sc_.bit_widths,
                    sigma_maxes=co.apply_sigmas(sc_.sigma_maxes),
                    vdds=co.apply_vdds(sc_.vdds),
                    p_x_ones=sc_.p_x_ones,
                    w_bit_sparsities=sc_.w_bit_sparsities,
                    ms=sc_.ms, tdc_archs=sc_.tdc_archs,
                    lib=co.apply_lib(sc_.techlib))

    def sweep(self, scenario, corner=None,
              minimize_over: Sequence[str] = (),
              use_cache: bool = True, device=None) -> design_grid.DesignGrid:
        return self.sweep_info(scenario, corner, minimize_over, use_cache,
                               device)[0]

    def sweep_info(self, scenario, corner=None,
                   minimize_over: Sequence[str] = (),
                   use_cache: bool = True, device=None
                   ) -> tuple[design_grid.DesignGrid, dict]:
        """`scenario.sweep_scenario` through the cache (the same numbers;
        only the dispatch path differs)."""
        sc_ = scenario_mod.get_scenario(scenario)
        co = scenario_mod.get_corner(corner)
        g, info = self.sweep_axes_info(
            minimize_over=minimize_over, use_cache=use_cache, device=device,
            **self._corner_axes(sc_, co))
        info.update(scenario=sc_.name, corner=co.name)
        return g, info

    def sweep_scenarios(self, scenario,
                        corners: Sequence | None = None,
                        minimize_over: Sequence[str] = (),
                        parallel: bool | None = None,
                        use_cache: bool = True, device=None
                        ) -> dict[str, design_grid.DesignGrid]:
        """All corners of a scenario, one after another on the service's
        device (the reference's thread-pool fan-out is not ported:
        ``parallel=True`` raises)."""
        if parallel:
            raise _not_ported("the corner fan-out (parallel=True)")
        sc_ = scenario_mod.get_scenario(scenario)
        cos = [scenario_mod.get_corner(c)
               for c in (corners if corners is not None else sc_.corners)]
        return {co.name: self.sweep(sc_, co, minimize_over, use_cache,
                                    device)
                for co in cos}

    def refine(self, *args, **kw):
        raise _not_ported("incremental grid refinement (refine)")

    # -- memoized point queries (the policy-resolve path) -------------------
    def evaluate_td(self, n, sigma_max, vdd=C.VDD_NOM, *, bits: int,
                    m: int = C.M_DEFAULT, clip_range: bool = True,
                    tdc_arch: str = "hybrid", relax_tdc: bool = True,
                    p_x_one=C.P_X_ONE, w_bit_sparsity=C.W_BIT_SPARSITY,
                    lib: TechLib | str | None = None, device=None) -> dict:
        """`design_grid.evaluate_td_batched` behind a content-keyed memo:
        re-resolving the same network's layer vector is a dict lookup."""
        args = np.broadcast_arrays(
            np.asarray(n, np.float64), np.asarray(sigma_max, np.float64),
            np.asarray(vdd, np.float64), np.asarray(p_x_one, np.float64),
            np.asarray(w_bit_sparsity, np.float64))
        lib_r = get_techlib(lib)
        h = hashlib.sha256(
            f"td-v1|{_code_salt()}|{lib_r.content_hash()}|{bits}|{m}|"
            f"{tdc_arch}|{clip_range}|{relax_tdc}|{args[0].shape}"
            .encode("ascii"))
        for a in args:
            h.update(np.ascontiguousarray(a).tobytes())
        key = h.hexdigest()
        with self._lock:
            self.stats.td_queries += 1
            hit = self._points.get(key)
            if hit is not None:
                self._points.move_to_end(key)
                self.stats.td_hits += 1
                return {k: v.copy() for k, v in hit.items()}
        res = design_grid.evaluate_td_batched(
            args[0], args[1], args[2], bits=int(bits), m=int(m),
            clip_range=clip_range, tdc_arch=tdc_arch, relax_tdc=relax_tdc,
            p_x_one=args[3], w_bit_sparsity=args[4], lib=lib_r,
            device=self._device(device))
        self._point_put(key, res)
        return {k: v.copy() for k, v in res.items()}

    def optimal_td_vdds(self, n, sigma_max, *, bits: int,
                        vdds: Sequence[float] = scenario_mod.PAPER_VDD_GRID,
                        m: int = C.M_DEFAULT, tdc_arch: str = "hybrid",
                        p_x_one: float = C.P_X_ONE,
                        w_bit_sparsity: float = C.W_BIT_SPARSITY,
                        lib: TechLib | str | None = None,
                        device=None) -> np.ndarray:
        """`scenario.optimal_td_vdds` behind the same memo (the per-layer
        supply argmin of `apply_scenario`)."""
        n_a = np.atleast_1d(np.asarray(n, np.float64))
        s_a = np.atleast_1d(np.asarray(sigma_max, np.float64))
        n_a, s_a = np.broadcast_arrays(n_a, s_a)
        lib_r = get_techlib(lib)
        h = hashlib.sha256(
            f"vddopt-v1|{_code_salt()}|{lib_r.content_hash()}|{bits}|{m}|"
            f"{tdc_arch}|{float(p_x_one).hex()}|{float(w_bit_sparsity).hex()}"
            f"|{_fmt_floats(vdds)}|{n_a.shape}".encode("ascii"))
        h.update(np.ascontiguousarray(n_a).tobytes())
        h.update(np.ascontiguousarray(s_a).tobytes())
        key = h.hexdigest()
        with self._lock:
            self.stats.vdd_opt_queries += 1
            hit = self._points.get(key)
            if hit is not None:
                self._points.move_to_end(key)
                self.stats.vdd_opt_hits += 1
                return hit["vdds"].copy()
        v = scenario_mod.optimal_td_vdds(
            n_a, s_a, bits=int(bits), vdds=vdds, m=int(m),
            tdc_arch=tdc_arch, p_x_one=p_x_one,
            w_bit_sparsity=w_bit_sparsity, lib=lib_r,
            device=self._device(device))
        self._point_put(key, {"vdds": v})
        return v.copy()

    def _point_put(self, key: str, value: dict) -> None:
        with self._lock:
            self._points[key] = value
            self._points.move_to_end(key)
            while len(self._points) > self._max_points:
                self._points.popitem(last=False)
                self.stats.evictions += 1


# ---------------------------------------------------------------------------
# Process-wide default service
# ---------------------------------------------------------------------------
_SERVICE: ExplorerService | None = None
_SERVICE_LOCK = threading.Lock()


def service() -> ExplorerService:
    """The process-wide default `ExplorerService` (created on first use, on
    CUDA).  Every policy solve in `tdsim.policy` routes through it."""
    global _SERVICE
    with _SERVICE_LOCK:
        if _SERVICE is None:
            _SERVICE = ExplorerService()
        return _SERVICE


def set_service(svc: ExplorerService | None) -> ExplorerService | None:
    """Swap the default service (tests; returns the previous one)."""
    global _SERVICE
    with _SERVICE_LOCK:
        prev, _SERVICE = _SERVICE, svc
        return prev
