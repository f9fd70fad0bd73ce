"""Design-space explorer service, the in-process part (port of
`repro/core/explorer.py`): a sweep cache in memory and on disk, the
corner fan-out, incremental grid refinement and a memo of point queries.

``ExplorerService``
    A long-lived service over the scenario engine.  It caches sweep
    results in memory (LRU) and, with a ``cache_dir``
    (``REPRO_EXPLORER_CACHE_DIR`` for the default service), on disk as
    `DesignGrid.save_npz` files written under an atomic rename, keyed on
    (TechLib content hash, corner-applied axis values, grid shape,
    minimize_over reductions, code-version salt), so a repeated or
    reduction-sliced query -- winner map, Pareto frontier,
    `minimize_over_*` argmin, policy resolve -- is a dictionary lookup,
    across processes with a disk store.  The point queries
    (`evaluate_td`, `optimal_td_vdds`) are memoized the same way and
    return copies.  Counters live in `ExplorerStats`.  ``device`` (None =
    CUDA) is where a miss sweeps; a call may name another.

``sweep_scenarios(parallel=True)``
    A thread per corner, corners round-robined over the visible CUDA
    devices (each thread under `torch.cuda.device(i)`), the results
    bit-identical to the serial loop.

``refine``
    A coarse sweep over a virtual dense axis (``target`` values, the Vdd
    axis by default), then dense re-sweeps of only the intervals that can
    still move some point's argmin, merged into one grid
    (`design_grid.concat_along_axis`) and reduced: the argmin at the
    dense axis's resolution from a fraction of its points
    (`RefineResult`).

``service()`` / ``set_service()``
    The process-wide default instance; `tdsim.policy` routes every policy
    solve through it, so re-resolving a network is a memo lookup.

One lock (an RLock) guards the caches, the disk store's reads and
writes and the counters, so a staged rebuild thread may solve through the
service while the serve loop does; `count_fallback` counts a remote
resolve degraded to this process
(`launch.explore.resolve_with_fallback`).  The TCP front end is
`launch/explore.py`.  The code salt hashes the port's own engine
sources, so a torch grid never shares a key (nor a disk file) with a JAX
grid.
"""
from __future__ import annotations

import collections
import dataclasses
import functools
import hashlib
import inspect
import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Sequence

import numpy as np
import torch

from repro_torch.core import chain, design_grid
from repro_torch.core import constants as C
from repro_torch.core import scenario as scenario_mod
from repro_torch.core.techlib import TechLib, get_techlib

__all__ = ["ExplorerService", "ExplorerStats", "RefineResult", "service",
           "set_service", "grid_cache_key"]

_REDUCERS = {
    "vdd": design_grid.minimize_over_vdd,
    "m": design_grid.minimize_over_m,
    "tdc_arch": design_grid.minimize_over_tdc_arch,
}


# axis name -> sweep_axes keyword holding that axis's values
_AXIS_KW = {"n": "ns", "sigma": "sigma_maxes", "vdd": "vdds",
            "p_x_one": "p_x_ones", "w_bit_sparsity": "w_bit_sparsities"}


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
    ``points_served`` counts points returned to callers: the gap is what
    the caches saved."""
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


@dataclasses.dataclass(frozen=True)
class RefineResult:
    """Outcome of one incremental-refinement run.

    ``grid`` is the merged grid after the requested reductions (for the
    default Vdd refinement `minimize_over_vdd`, so ``vdd_opt`` holds each
    point's supply at the dense axis's resolution); ``merged`` is the raw
    merged grid (a non-uniform refined axis: the coarse values and the
    argmin neighborhoods).  ``effective_points`` is the dense resolution
    the argmin is exact against (the other axes' product x ``target``);
    ``points_evaluated`` is what was solved."""
    grid: design_grid.DesignGrid
    merged: design_grid.DesignGrid
    refine_axis: str
    dense_values: np.ndarray
    evaluated_values: np.ndarray
    levels: int
    points_evaluated: int
    effective_points: int


class ExplorerService:
    """Long-lived design-space explorer (see module docstring)."""

    def __init__(self, cache_dir: str | None = None,
                 max_memory_entries: int = 64,
                 max_point_entries: int = 512, device=None):
        self.cache_dir = cache_dir or None
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
        if self.cache_dir:
            os.makedirs(self.cache_dir, exist_ok=True)

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
        """Drop the in-memory caches (the disk store is left alone)."""
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

    def _disk_path(self, key: str) -> str | None:
        return (os.path.join(self.cache_dir, key + ".npz")
                if self.cache_dir else None)

    def _grid_get(self, key: str) -> tuple[design_grid.DesignGrid | None,
                                           str]:
        """The cached grid of ``key`` and where it came from ("memory",
        "disk"; None and "miss" when neither has it).  A disk hit enters
        the LRU."""
        with self._lock:
            g = self._grids.get(key)
            if g is not None:
                self._grids.move_to_end(key)
                return g, "memory"
            path = self._disk_path(key)
            if path and os.path.exists(path):
                g = design_grid.DesignGrid.load_npz(path)
                self._grid_put(key, g, to_disk=False)
                return g, "disk"
        return None, "miss"

    def _grid_put(self, key: str, g: design_grid.DesignGrid,
                  to_disk: bool = True) -> None:
        with self._lock:
            self._grids[key] = g
            self._grids.move_to_end(key)
            while len(self._grids) > self._max_grids:
                self._grids.popitem(last=False)
                self.stats.evictions += 1
            path = self._disk_path(key)
            if to_disk and path and not os.path.exists(path):
                # the temporary name keeps the .npz suffix (np.savez
                # appends it); the rename is atomic, so another process
                # writing the same key races benignly to identical content
                tmp = (path[:-len(".npz")]
                       + f".tmp.{os.getpid()}.{threading.get_ident()}.npz")
                try:
                    g.save_npz(tmp)
                    os.replace(tmp, path)
                finally:
                    if os.path.exists(tmp):
                        os.remove(tmp)

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
        """One (possibly reduced) sweep through the caches.  Returns the
        grid plus an info dict: ``source`` in {memory, disk, computed} and
        ``elapsed_ms``.  Cached grids are shared -- treat them as
        read-only."""
        ax = self._normalize_axes(**axes)
        minimize_over = tuple(minimize_over)
        key = grid_cache_key(**ax, minimize_over=minimize_over)
        t0 = time.perf_counter()
        with self._lock:
            self.stats.queries += 1
        g, source = self._grid_get(key) if use_cache else (None, "bypass")
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
                if source == "memory":
                    self.stats.memory_hits += 1
                else:
                    self.stats.disk_hits += 1
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

    # -- corner fan-out ----------------------------------------------------
    def sweep_scenarios(self, scenario,
                        corners: Sequence | None = None,
                        minimize_over: Sequence[str] = (),
                        parallel: bool | None = None,
                        use_cache: bool = True, device=None
                        ) -> dict[str, design_grid.DesignGrid]:
        """All corners of a scenario.  ``parallel`` runs a thread per
        corner, corners round-robined over `torch.cuda.device_count()`
        devices, each thread under `torch.cuda.device(i)` (the current
        device is a thread's own); on the CPU, or on one card, the threads
        share the device and overlap only their host work.  The default is
        the threads when there are several corners and several cards, else
        the serial loop: unlike the reference's jitted sweeps, whose threads
        overlap compilation, the port's threads on one card contend for its
        one stream and were slower than the loop on an H100.  The results
        are bit-identical to the serial loop's."""
        sc_ = scenario_mod.get_scenario(scenario)
        cos = [scenario_mod.get_corner(c)
               for c in (corners if corners is not None else sc_.corners)]
        dev = self._device(device)
        on_cuda = dev is None or torch.device(dev).type == "cuda"
        n_dev = torch.cuda.device_count() if on_cuda else 0
        if parallel is None:
            parallel = n_dev > 1
        if not parallel or len(cos) <= 1:
            return {co.name: self.sweep(sc_, co, minimize_over, use_cache,
                                        device)
                    for co in cos}

        def one(i: int, co: scenario_mod.Corner) -> design_grid.DesignGrid:
            if not n_dev:
                return self.sweep(sc_, co, minimize_over, use_cache, dev)
            with torch.cuda.device(i % n_dev):
                return self.sweep(sc_, co, minimize_over, use_cache,
                                  torch.device("cuda", i % n_dev))

        with ThreadPoolExecutor(max_workers=len(cos)) as ex:
            futs = [(co.name, ex.submit(one, i, co))
                    for i, co in enumerate(cos)]
            out = {name: f.result() for name, f in futs}
        with self._lock:
            self.stats.fanout_sweeps += len(cos)
        return out

    # -- incremental refinement --------------------------------------------
    def refine(self, scenario, corner=None, *, refine_axis: str = "vdd",
               lo: float | None = None, hi: float | None = None,
               target: int = 4096, coarse: int = 9, tau: float = 0.05,
               max_axis_values: int = 128, max_levels: int = 12,
               metric: str = "e_mac",
               minimize_over: Sequence[str] | None = None,
               use_cache: bool = True, device=None) -> RefineResult:
        """Coarse sweep, then dense re-sweeps of the near-optimal intervals
        (the reference's algorithm, line for line).

        The refined axis is replaced by a virtual dense grid of ``target``
        values spanning [lo, hi] (default: the corner-applied scenario
        axis's span).  Level 0 evaluates a ``coarse`` subsample of its
        index space; every later level flags the evaluated intervals that
        could still move some grid point's argmin -- the interval that
        brackets the point's current argmin, and those where an integer
        output (redundancy, TDC q) changes while the interval's endpoint
        minimum lies within ``tau`` of the point's range above its best --
        and re-sweeps a ``coarse`` subsample of each, until every flagged
        interval is down to adjacent dense indices, ``max_axis_values``
        values have been evaluated or ``max_levels`` levels have run.
        Each level sweeps only the new values (one cached `sweep_axes`
        call) and merges them (`design_grid.concat_along_axis`).  For
        ``refine_axis="vdd"`` the merged grid is reduced by
        `minimize_over_vdd`; other axes return it unreduced unless
        ``minimize_over`` says otherwise."""
        if refine_axis not in _AXIS_KW:
            raise ValueError(f"cannot refine axis {refine_axis!r} "
                             f"(refinable: {sorted(_AXIS_KW)})")
        if refine_axis == "n":
            raise ValueError("n is integer-valued; refine a continuous axis")
        sc_ = scenario_mod.get_scenario(scenario)
        co = scenario_mod.get_corner(corner)
        axes = self._corner_axes(sc_, co)
        kw = _AXIS_KW[refine_axis]
        base = np.asarray(axes[kw] if axes[kw] is not None
                          else (float(chain.sigma_max_exact()),), np.float64)
        lo = float(base.min()) if lo is None else float(lo)
        hi = float(base.max()) if hi is None else float(hi)
        target = int(target)
        if target < 2 or hi <= lo:
            raise ValueError("need target >= 2 and hi > lo to refine")
        coarse = max(3, int(coarse))
        dense = np.linspace(lo, hi, target)
        ax_pos = design_grid._AXES.index(refine_axis)

        def sweep_at(idx: np.ndarray) -> design_grid.DesignGrid:
            vals = tuple(float(v) for v in dense[np.sort(idx)])
            return self.sweep_axes(use_cache=use_cache, device=device,
                                   **{**axes, kw: vals})

        eidx = np.unique(np.round(
            np.linspace(0, target - 1, min(coarse, target))).astype(int))
        merged = sweep_at(eidx)
        levels = 1
        while levels < max_levels:
            # the intervals that can still move a point's argmin: the one
            # bracketing it, and those where redundancy or q changes (a
            # notch on the smooth envelope) within the tau band of the
            # point's range (capped at |best|)
            n_e = len(eidx)
            arr = np.moveaxis(getattr(merged, metric), ax_pos,
                              -1).reshape(-1, n_e)
            sign = -arr if metric == "throughput" else arr
            best = sign.min(axis=-1, keepdims=True)
            spread = np.minimum(sign.max(axis=-1, keepdims=True) - best,
                                np.abs(best))
            near = np.minimum(sign[:, :-1], sign[:, 1:]) <= best + tau * spread
            trans = np.zeros_like(near)
            for f in ("redundancy", "tdc_q"):
                fv = np.moveaxis(getattr(merged, f), ax_pos,
                                 -1).reshape(-1, n_e)
                trans |= fv[:, :-1] != fv[:, 1:]
            pos = sign.argmin(axis=-1)
            bracket = np.zeros_like(near)
            rows = np.arange(near.shape[0])
            bracket[rows, np.clip(pos - 1, 0, n_e - 2)] = True
            bracket[rows, np.clip(pos, 0, n_e - 2)] = True
            flagged = np.any(bracket | (trans & near), axis=0)
            eset = set(int(i) for i in eidx)
            new: set[int] = set()
            for i in np.nonzero(flagged)[0]:
                left, right = int(eidx[i]), int(eidx[i + 1])
                if right - left <= 1:
                    continue          # already at the dense resolution
                cand = np.unique(np.round(
                    np.linspace(left, right, coarse)).astype(int))
                new.update(int(c) for c in cand if int(c) not in eset)
            if not new:
                break                 # every near-optimal interval resolved
            new_idx = np.asarray(sorted(new), int)
            room = max_axis_values - len(eidx)
            if room <= 0:
                break                 # the axis-value budget is spent
            if len(new_idx) > room:
                sel = np.unique(np.round(
                    np.linspace(0, len(new_idx) - 1, room)).astype(int))
                new_idx = new_idx[sel]
            merged = design_grid.concat_along_axis(
                [merged, sweep_at(new_idx)], refine_axis)
            eidx = np.union1d(eidx, new_idx)
            levels += 1
        if minimize_over is None:
            minimize_over = ("vdd",) if refine_axis == "vdd" else ()
        reduced = merged
        for axis in minimize_over:
            reduced = _REDUCERS[axis](reduced)
        with self._lock:
            self.stats.refine_runs += 1
            self.stats.refine_levels += levels
        other = merged.n_points // len(eidx)
        return RefineResult(grid=reduced, merged=merged,
                            refine_axis=refine_axis, dense_values=dense,
                            evaluated_values=dense[eidx], levels=levels,
                            points_evaluated=merged.n_points,
                            effective_points=other * target)

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
    CUDA; its disk store at ``REPRO_EXPLORER_CACHE_DIR`` when that is
    set).  Every policy solve in `tdsim.policy` routes through it."""
    global _SERVICE
    with _SERVICE_LOCK:
        if _SERVICE is None:
            _SERVICE = ExplorerService(
                cache_dir=os.environ.get("REPRO_EXPLORER_CACHE_DIR") or None)
        return _SERVICE


def set_service(svc: ExplorerService | None) -> ExplorerService | None:
    """Swap the default service (tests; returns the previous one)."""
    global _SERVICE
    with _SERVICE_LOCK:
        prev, _SERVICE = _SERVICE, svc
        return prev
