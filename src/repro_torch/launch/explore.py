"""Explorer service front end: a JSON-line TCP server over the process-wide
`core.explorer.ExplorerService`, and its client (port of
`repro/launch/explore.py`).

    PYTHONPATH=src python -m repro_torch.launch.explore --port 7749 \
        --preload vdd-opt:ss [--cache-dir DIR]

One long-lived process owns the sweeps (on the card unless ``--device``
says otherwise) and the grid cache; any number of short-lived clients ask
questions over a plain wire protocol: one JSON object per line, one JSON
object back.

Protocol (request ``op`` field):

``ping``
    Liveness: ``{"op": "ping"}`` -> ``{"ok": true, "pid": ..., "uptime_s"}``.
``stats``
    The cache counters (`ExplorerStats.snapshot`) and entry/byte counts.
``sweep``
    ``{"op": "sweep", "scenario": "edge", "corner": "ss",
    "minimize_over": ["vdd"], "result": "summary"}``; ``result`` is
    ``summary``, ``winners`` (the winning-domain map) or ``crossovers``.
``refine``
    ``{"op": "refine", "scenario": "vdd-opt", "corner": "tt", "target":
    4096, ...}`` (any of ``refine_axis``, ``lo``, ``hi``, ``target``,
    ``coarse``, ``tau``, ``max_axis_values``, ``max_levels``,
    ``metric``): `ExplorerService.refine`'s levels, axis sizes and point
    counts, and ``vdd_opt`` when the reduced grid has at most 256 points.
``resolve``
    Per-layer specs in, solved per-layer (R, q, sigma_chain, Vdd)
    policies out, through the same memoized solves `tdsim.policy` makes in
    process; ``vdd_grid`` asks for the supply-spanning solve.
``shutdown``
    Stop the server after replying.

`request` is the client: separate connect and read budgets and bounded
jittered retries, raising the typed `ExplorerUnreachable` when the server
stays dark, so that `resolve_with_fallback` can degrade to the in-process
service (on the same device) instead of failing the request.
"""
from __future__ import annotations

import argparse
import json
import os
import socket
import socketserver
import threading
import time

import numpy as np

from repro_torch.core import explorer as explorer_mod
from repro_torch.core import scenario as scenario_mod

DEFAULT_PORT = int(os.environ.get("REPRO_EXPLORER_PORT", "7749"))

__all__ = ["ExplorerServer", "ExplorerUnreachable", "request",
           "resolve_with_fallback", "dispatch", "main", "DEFAULT_PORT"]


class ExplorerUnreachable(ConnectionError):
    """The explorer server did not answer within the retry budget.

    A ConnectionError (hence OSError), so it is retryable under
    `ft.RETRYABLE` and caught by `ft.ResolverChain`'s default filter;
    callers that can degrade catch this type and resolve in process."""


def _jsonable(v):
    if isinstance(v, np.ndarray):
        return v.tolist()
    if isinstance(v, np.integer):
        return int(v)
    if isinstance(v, np.floating):
        return float(v)
    return v


def _sweep_payload(svc: explorer_mod.ExplorerService, req: dict) -> dict:
    grid, info = svc.sweep_info(req.get("scenario", "paper-relaxed"),
                                req.get("corner"),
                                tuple(req.get("minimize_over", ())))
    out = {"ok": True, "op": "sweep", "scenario": info["scenario"],
           "corner": info["corner"], "source": info["source"],
           "elapsed_ms": info["elapsed_ms"], "n_points": grid.n_points,
           "shape": list(grid.shape), "domains": list(grid.domains)}
    result = req.get("result", "summary")
    if result == "summary":
        pass
    elif result == "winners":
        out["winners"] = grid.winners().tolist()
    elif result == "crossovers":
        from repro_torch.core import design_grid
        out["crossovers"] = [
            {k: _jsonable(v) for k, v in rec.items()}
            for rec in design_grid.domain_crossovers(grid)]
    else:
        raise ValueError(f"unknown sweep result kind {result!r} "
                         "(summary | winners | crossovers)")
    return out


def _refine_payload(svc: explorer_mod.ExplorerService, req: dict) -> dict:
    kw = {k: req[k] for k in ("refine_axis", "lo", "hi", "target", "coarse",
                              "tau", "max_axis_values", "max_levels",
                              "metric") if k in req}
    res = svc.refine(req.get("scenario", "vdd-opt"), req.get("corner"), **kw)
    out = {"ok": True, "op": "refine", "refine_axis": res.refine_axis,
           "levels": res.levels, "dense_size": len(res.dense_values),
           "evaluated_axis_values": len(res.evaluated_values),
           "points_evaluated": res.points_evaluated,
           "effective_points": res.effective_points}
    if res.grid.vdd_opt is not None and res.grid.vdd_opt.size <= 256:
        out["vdd_opt"] = res.grid.vdd_opt.ravel().tolist()
    return out


def _policy_json(p) -> dict:
    return {"bits_a": p.bits_a, "bits_w": p.bits_w, "n_chain": p.n_chain,
            "redundancy": p.redundancy, "tdc_q": p.tdc_q,
            "sigma_chain": p.sigma_chain, "vdd": p.vdd, "m": p.m,
            "tdc_arch": p.tdc_arch, "p_x_one": p.p_x_one,
            "w_bit_sparsity": p.w_bit_sparsity, "sigma_max": p.sigma_max}


def _resolve_payload(svc: explorer_mod.ExplorerService, req: dict) -> dict:
    from repro_torch.tdsim import policy as policy_mod

    dflt = policy_mod.TDLayerSpec()
    specs = [policy_mod.TDLayerSpec(
        bits_a=int(l.get("bits_a", 4)), bits_w=int(l.get("bits_w", 4)),
        n_chain=int(l.get("n_chain", 576)),
        sigma_max=l.get("sigma_max"), vdd=float(l.get("vdd", 0.8)),
        p_x_one=float(l.get("p_x_one", dflt.p_x_one)),
        w_bit_sparsity=float(l.get("w_bit_sparsity", dflt.w_bit_sparsity)),
        m=int(l.get("m", dflt.m)),
        tdc_arch=str(l.get("tdc_arch", dflt.tdc_arch)))
        for l in req["layers"]]
    dev = svc.device
    if req.get("scenario"):
        specs = policy_mod.apply_scenario(
            specs, req["scenario"], req.get("corner"),
            minimize_vdd=bool(req.get("minimize_vdd", True)), device=dev)
    if req.get("vdd_grid"):
        pols = policy_mod.solve_td_policies_over_vdd(
            specs, [float(v) for v in req["vdd_grid"]], device=dev)
    else:
        pols = policy_mod.solve_td_policies(specs, dev)
    return {"ok": True, "op": "resolve",
            "policies": [_policy_json(p) for p in pols]}


def dispatch(svc: explorer_mod.ExplorerService, req: dict,
             started_at: float | None = None) -> dict:
    """One request -> one response dict.  Raises nothing: an error becomes
    ``{"ok": false, "error": ...}``, so a bad query cannot kill the
    server."""
    try:
        op = req.get("op", "ping")
        if op == "ping":
            return {"ok": True, "op": "ping", "pid": os.getpid(),
                    "uptime_s": time.time() - (started_at
                                               or svc.started_at),
                    "scenarios": sorted(scenario_mod.SCENARIOS),
                    "corners": sorted(scenario_mod.CORNERS)}
        if op == "stats":
            return {"ok": True, "op": "stats",
                    "stats": svc.stats.snapshot(),
                    "cache_entries": svc.cache_entries,
                    "cache_bytes": svc.cache_bytes,
                    "cache_dir": svc.cache_dir}
        if op == "sweep":
            return _sweep_payload(svc, req)
        if op == "refine":
            return _refine_payload(svc, req)
        if op == "resolve":
            return _resolve_payload(svc, req)
        if op == "shutdown":
            return {"ok": True, "op": "shutdown"}
        return {"ok": False, "error": f"unknown op {op!r}"}
    except Exception as e:  # noqa: BLE001 -- wire boundary
        return {"ok": False, "error": f"{type(e).__name__}: {e}"}


class ExplorerServer:
    """Threaded JSON-line TCP server around one `ExplorerService`.

    ``port=0`` binds an ephemeral port (tests); `address` is the bound
    (host, port).  `start_background` serves from a daemon thread;
    `serve_forever` blocks (the CLI)."""

    def __init__(self, service: explorer_mod.ExplorerService | None = None,
                 host: str = "127.0.0.1", port: int = DEFAULT_PORT):
        self.service = service or explorer_mod.service()
        outer = self

        class Handler(socketserver.StreamRequestHandler):
            def handle(self) -> None:
                for raw in self.rfile:
                    line = raw.strip()
                    if not line:
                        continue
                    try:
                        req = json.loads(line)
                    except json.JSONDecodeError as e:
                        resp = {"ok": False, "error": f"bad json: {e}"}
                    else:
                        resp = dispatch(outer.service, req)
                    self.wfile.write(json.dumps(resp).encode() + b"\n")
                    self.wfile.flush()
                    if resp.get("op") == "shutdown" and resp.get("ok"):
                        threading.Thread(target=outer.shutdown,
                                         daemon=True).start()
                        return

        class Server(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True

        self._tcp = Server((host, port), Handler)
        self.address: tuple[str, int] = self._tcp.server_address[:2]

    def serve_forever(self) -> None:
        self._tcp.serve_forever()

    def start_background(self) -> "ExplorerServer":
        threading.Thread(target=self._tcp.serve_forever, daemon=True).start()
        return self

    def shutdown(self) -> None:
        self._tcp.shutdown()
        self._tcp.server_close()


def request(payload: dict, host: str = "127.0.0.1",
            port: int = DEFAULT_PORT, timeout: float | None = None,
            connect_timeout: float = 2.0, read_timeout: float = 300.0,
            retries: int = 2, backoff_s: float = 0.2,
            retry_seed: int | None = None) -> dict:
    """Send one request to a running explorer server and return its reply.

    Connection and read get separate budgets: a dead server fails in
    ``connect_timeout`` seconds, and the read budget starts once the
    server has accepted the query.  Failures retry up to ``retries`` times
    under `ft.RetryPolicy`'s jittered backoff; then `ExplorerUnreachable`
    carries the last error.  ``timeout`` sets both budgets at once."""
    from repro_torch import ft

    if timeout is not None:
        connect_timeout = read_timeout = timeout
    policy = ft.RetryPolicy(max_restarts=retries, backoff_s=backoff_s,
                            seed=retry_seed)
    attempt = 0
    while True:
        try:
            with socket.create_connection((host, port),
                                          timeout=connect_timeout) as sk:
                sk.settimeout(read_timeout)
                sk.sendall(json.dumps(payload).encode() + b"\n")
                buf = b""
                while not buf.endswith(b"\n"):
                    chunk = sk.recv(65536)
                    if not chunk:
                        break
                    buf += chunk
            if not buf:
                raise ConnectionError("server closed without replying")
            return json.loads(buf)
        except (OSError, TimeoutError) as e:
            attempt += 1
            if attempt > retries:
                raise ExplorerUnreachable(
                    f"explorer at {host}:{port} unreachable after "
                    f"{attempt} attempt(s): {e!r}") from e
            time.sleep(policy.delay_s(attempt))


def resolve_with_fallback(specs, host: str = "127.0.0.1",
                          port: int = DEFAULT_PORT,
                          scenario=None, corner=None, vdd_grid=None,
                          device=None, **request_kw) -> tuple[list, str]:
    """Resolve per-layer TD policies through the explorer server,
    degrading to the in-process service when it is unreachable.

    ``specs`` is a list of `tdsim.policy.TDLayerSpec`.  Returns
    ``(policies, source)``, source ``"remote"`` or ``"local"``; the local
    path solves on ``device`` (None: the in-process service's device) and
    counts in `ExplorerStats.fallback_resolves` through the locked
    `count_fallback` (a staged rebuild thread may degrade while the serve
    loop does).  ``vdd_grid`` asks for the supply-spanning solve on either
    path.  A server that rejects the query (``ok: false``) raises: that is
    a data error, not an outage."""
    from repro_torch.tdsim import policy as policy_mod

    payload = {"op": "resolve",
               "layers": [{"bits_a": sp.bits_a, "bits_w": sp.bits_w,
                           "n_chain": sp.n_chain, "sigma_max": sp.sigma_max,
                           "vdd": sp.vdd, "p_x_one": sp.p_x_one,
                           "w_bit_sparsity": sp.w_bit_sparsity,
                           "m": sp.m, "tdc_arch": sp.tdc_arch}
                          for sp in specs]}
    if scenario is not None:
        payload["scenario"] = scenario
        payload["corner"] = corner
    if vdd_grid is not None:
        payload["vdd_grid"] = [float(v) for v in vdd_grid]
    try:
        resp = request(payload, host, port, **request_kw)
    except ExplorerUnreachable:
        explorer_mod.service().count_fallback()
        if scenario is not None:
            specs = policy_mod.apply_scenario(specs, scenario, corner,
                                              device=device)
        if vdd_grid is not None:
            return policy_mod.solve_td_policies_over_vdd(
                specs, vdd_grid, device=device), "local"
        return policy_mod.solve_td_policies(specs, device), "local"
    if not resp.get("ok"):
        raise RuntimeError(f"explorer resolve failed: {resp.get('error')}")
    pols = [policy_mod.TDPolicy(
        mode="td", bits_a=int(p["bits_a"]), bits_w=int(p["bits_w"]),
        n_chain=int(p["n_chain"]), redundancy=int(p["redundancy"]),
        sigma_chain=float(p["sigma_chain"]), tdc_q=int(p["tdc_q"]),
        m=int(p["m"]), tdc_arch=p["tdc_arch"], vdd=float(p["vdd"]),
        p_x_one=float(p.get("p_x_one", policy_mod.C.P_X_ONE)),
        w_bit_sparsity=float(p.get("w_bit_sparsity",
                                   policy_mod.C.W_BIT_SPARSITY)),
        sigma_max=p["sigma_max"]) for p in resp["policies"]]
    return pols, "remote"


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        description="Long-lived design-space explorer service (JSON-line "
                    "TCP)")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=DEFAULT_PORT)
    ap.add_argument("--device", default=None,
                    help="where sweeps and solves run (default cuda)")
    ap.add_argument("--preload", action="append", default=[],
                    metavar="SCENARIO[:CORNER]",
                    help="sweep these before accepting queries (repeatable)")
    ap.add_argument("--cache-dir", default=None,
                    help="persistent sweep cache (default: "
                         "$REPRO_EXPLORER_CACHE_DIR, else memory only)")
    args = ap.parse_args(argv)

    from repro_torch import device as device_mod
    cache_dir = args.cache_dir or os.environ.get("REPRO_EXPLORER_CACHE_DIR")
    svc = explorer_mod.ExplorerService(
        cache_dir=cache_dir or None, device=device_mod.resolve(args.device))
    explorer_mod.set_service(svc)
    for spec in args.preload:
        scenario, _, corner = spec.partition(":")
        _, info = svc.sweep_info(scenario, corner or None)
        print(f"preloaded {scenario}/{info['corner']}: {info['source']} "
              f"in {info['elapsed_ms']:.0f} ms")
    server = ExplorerServer(svc, args.host, args.port)
    print(f"explorer service listening on "
          f"{server.address[0]}:{server.address[1]} (device {svc.device}, "
          f"cache_dir={svc.cache_dir or 'memory-only'})")
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        server.shutdown()


if __name__ == "__main__":
    main()
