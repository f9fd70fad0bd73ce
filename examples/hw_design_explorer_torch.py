"""Design-space explorer CLI over the batched engine, on the PyTorch port.

The same flags, output and printed lines as `examples/hw_design_explorer.py`,
through `repro_torch` (the sweeps run on CUDA by default; `--device cpu`
for the host), with `repro-torch-explore` / `python -m
repro_torch.launch.explore` as the server.

Evaluates an arbitrary (N x B x sigma x Vdd x activity x sparsity x m x
tdc_arch) grid for all three domains as one batched call and emits a winner
map (table), CSV or JSON, plus the domain-crossover boundaries the paper's
Figs. 9/11 read off qualitatively.  Named scenarios and technology
corners come from the scenario engine (`repro_torch.core.scenario`): a
corner shifts the supply grid, derates the budget AND perturbs the device
tables themselves (`--techlib` picks the base library the corner is
applied to).
`--minimize-vdd` folds the supply axis into a per-point argmin (the
retired `td_vdd_optimized` loop as a grid reduction); `--minimize-m` /
`--minimize-tdc-arch` do the same for the periphery axes opened by
`--sweep-m` / `--sweep-tdc-arch`.

    PYTHONPATH=src python examples/hw_design_explorer_torch.py
    PYTHONPATH=src python examples/hw_design_explorer_torch.py \
        --grid n=16..4096:24 bits=1,2,4,8 vdd=0.4..0.8:9 sigma=2.0 \
        --format csv --out grid.csv
    PYTHONPATH=src python examples/hw_design_explorer_torch.py \
        --scenario edge --corner ss --minimize-vdd
    PYTHONPATH=src python examples/hw_design_explorer_torch.py \
        --grid n=64,576 bits=4 sigma=2.0 --sweep-m 2,8,32 \
        --sweep-tdc-arch --corner ss --techlib 22fdx

Every in-process sweep routes through the long-lived explorer service
(`repro_torch.core.explorer`), so repeated invocations with `--cache-dir` (or
`REPRO_EXPLORER_CACHE_DIR`) hit the on-disk grid store instead of
re-sweeping.  To stop paying even process startup, run a server once and
query it:

    repro-torch-explore --cache-dir ~/.cache/repro-grids  # or: --serve
    PYTHONPATH=src python examples/hw_design_explorer_torch.py \
        --query sweep --scenario edge --corner ss
    PYTHONPATH=src python examples/hw_design_explorer_torch.py --query stats

Grid axis syntax: `key=v1,v2,...` (explicit list) or `key=lo..hi[:count]`
(range; geometric with integer rounding for n, linear otherwise).  Axes:
n, bits, sigma, vdd, px (activation activity p_x_one), wsp (weight bit
sparsity), m (delay-line parallelism), tdc (TDC architecture names).
"""
import argparse
import csv
import json
import os
import sys

import numpy as np

from repro_torch import device as device_mod
from repro_torch.core import constants as C
from repro_torch.core import design_grid
from repro_torch.core import explorer as explorer_mod
from repro_torch.core import scenario as sc
from repro_torch.core import techlib as tl
from repro_torch.launch import explore as explore_mod

DEFAULT_NS = (16, 32, 64, 128, 256, 576, 1024, 2048, 4096)
DEFAULT_BITS = (1, 2, 4, 8)


def _parse_axis(key: str, spec: str):
    if key == "tdc":
        return tuple(spec.split(","))
    try:
        if ".." in spec:
            lohi, _, cnt = spec.partition(":")
            lo, _, hi = lohi.partition("..")
            lo, hi = float(lo), float(hi)
            count = int(cnt) if cnt else 9
            if key == "n":
                vals = np.unique(np.round(np.geomspace(lo, hi, count))
                                 .astype(int))
                return tuple(int(v) for v in vals)
            if key in ("bits", "m"):
                vals = np.unique(np.round(np.linspace(lo, hi, count))
                                 .astype(int))
                return tuple(int(v) for v in vals)
            return tuple(float(v) for v in np.linspace(lo, hi, count))
        vals = [float(v) for v in spec.split(",")]
    except ValueError as e:
        raise SystemExit(f"bad --grid axis {key}={spec!r}: {e} "
                         f"(want `a,b,c` or `lo..hi[:count]`)") from None
    if key in ("n", "bits", "m"):
        return tuple(int(v) for v in vals)
    return tuple(vals)


def parse_grid(tokens) -> dict:
    axes = {"n": DEFAULT_NS, "bits": DEFAULT_BITS, "sigma": None,
            "vdd": (0.80,), "px": (C.P_X_ONE,), "wsp": (C.W_BIT_SPARSITY,),
            "m": (C.M_DEFAULT,), "tdc": ("hybrid",)}
    for tok in tokens or ():
        key, eq, spec = tok.partition("=")
        if not eq or key not in axes:
            raise SystemExit(f"bad --grid token {tok!r} "
                             f"(want n=|bits=|sigma=|vdd=|px=|wsp=|m=|tdc=)")
        axes[key] = _parse_axis(key, spec)
    return axes


def _vdd_label(g, vi: int) -> str:
    v = g.vdds[vi]
    return "opt" if np.isnan(v) else f"{v:.2f}"


def _m_label(g, mi: int) -> str:
    m = int(g.ms[mi])
    return "opt" if m < 0 else str(m)


def _tdc_label(g, ti: int) -> str:
    return g.tdc_archs[ti]


def print_winner_map(g, metric: str) -> None:
    tag = {"td": "T", "analog": "A", "digital": "D"}
    w = g.winner_names(metric)
    for si, s in enumerate(g.sigma_maxes):
        for vi in range(len(g.vdds)):
            for ai, a in enumerate(g.p_x_ones):
                for wi, ws in enumerate(g.w_bit_sparsities):
                    for mi in range(len(g.ms)):
                        for ti in range(len(g.tdc_archs)):
                            print(f"winner map, metric={metric}, "
                                  f"sigma_max={s:.3f}, "
                                  f"vdd={_vdd_label(g, vi)}, "
                                  f"p_x_one={a:.2f}, "
                                  f"w_sparsity={ws:.2f}, "
                                  f"m={_m_label(g, mi)}, "
                                  f"tdc={_tdc_label(g, ti)} "
                                  f"(T=time-domain A=analog D=digital)")
                            print("        " + " ".join(
                                f"B={b}" for b in g.bit_widths))
                            for ni, n in enumerate(g.ns):
                                row = "".join(
                                    f"  {tag[w[bi, ni, si, vi, ai, wi, mi, ti]]} "
                                    for bi in range(len(g.bit_widths)))
                                print(f"N={n:5d}" + row)


def print_detail(g) -> None:
    if 576 not in g.ns:
        return
    ni = list(g.ns).index(576)
    print("\nper-point detail at the paper baseline N=576 "
          f"(sigma={g.sigma_maxes[0]:.3f}, vdd={_vdd_label(g, 0)}, "
          f"m={_m_label(g, 0)}, tdc={_tdc_label(g, 0)}):")
    for bi, b in enumerate(g.bit_widths):
        for di, d in enumerate(g.domains):
            ix = (di, bi, ni, 0, 0, 0, 0, 0, 0)
            print(f"  B={b} {d:8s} {g.e_mac[ix]*1e15:9.2f} fJ/MAC  "
                  f"R={g.redundancy[ix]:4d}  thr={g.throughput[ix]:.2e}  "
                  f"area={g.area_per_mac[ix]*1e12:.2f} um^2  "
                  f"vdd={g.point_vdd(ix):.2f}  m={g.point_m(ix)}  "
                  f"tdc={g.point_tdc_arch(ix)}")


def main(argv=None):
    """Run the CLI on ``argv`` (None: the command line); returns the swept
    grid (None for --serve and --query)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--grid", nargs="*", metavar="AXIS=SPEC",
                    help="axes: n=, bits=, sigma=, vdd=, px=, wsp= "
                         "(list `a,b,c` or range `lo..hi[:count]`)")
    ap.add_argument("--sigma", type=float, default=None,
                    help="shorthand for a single error budget in output LSB "
                         "(default: exact regime)")
    ap.add_argument("--scenario", default=None,
                    help="named scenario from repro_torch.core.scenario."
                         "SCENARIOS (overrides --grid axes)")
    ap.add_argument("--corner", default=None,
                    help=f"technology corner ({'/'.join(sc.CORNERS)}; "
                         "default tt).  Shifts the supply grid, derates "
                         "the budget and perturbs the device tables")
    ap.add_argument("--techlib", default=None,
                    help=f"base technology library "
                         f"({'/'.join(sorted(tl.TECHLIBS))}; default "
                         "22fdx) the corner multipliers are applied to")
    ap.add_argument("--sweep-m", default=None, metavar="M1,M2,...",
                    help="sweep the delay-line parallelism m over these "
                         "values (shorthand for --grid m=...)")
    ap.add_argument("--sweep-tdc-arch", action="store_true",
                    help="sweep the TDC architecture axis over "
                         "hybrid and sar (shorthand for --grid "
                         "tdc=hybrid,sar)")
    ap.add_argument("--minimize-vdd", action="store_true",
                    help="reduce the Vdd axis to each point's "
                         "energy-minimizing supply (grid argmin)")
    ap.add_argument("--minimize-m", action="store_true",
                    help="reduce the m axis to each point's optimum "
                         "(records m_opt per point)")
    ap.add_argument("--minimize-tdc-arch", action="store_true",
                    help="reduce the TDC-architecture axis to each "
                         "point's optimum (records tdc_arch_opt)")
    ap.add_argument("--metric", default="e_mac",
                    choices=["e_mac", "throughput", "area_per_mac"])
    ap.add_argument("--format", default="table",
                    choices=["table", "csv", "json"])
    ap.add_argument("--out", default=None,
                    help="output path for csv/json (default: stdout)")
    ap.add_argument("--crossovers", action="store_true",
                    help="also print domain-crossover boundaries")
    ap.add_argument("--serve", action="store_true",
                    help="run a long-lived explorer service on --host/--port "
                         "and answer --query requests instead of sweeping "
                         "in-process")
    ap.add_argument("--query", default=None,
                    metavar="OP",
                    choices=["ping", "stats", "sweep", "refine", "shutdown"],
                    help="send one request to a running explorer service "
                         "(sweep/refine assemble the payload from "
                         "--scenario/--corner/--minimize-* flags) and print "
                         "the JSON reply")
    ap.add_argument("--host", default="127.0.0.1",
                    help="explorer service host for --serve/--query")
    ap.add_argument("--port", type=int, default=explore_mod.DEFAULT_PORT,
                    help="explorer service port for --serve/--query")
    ap.add_argument("--cache-dir", default=None,
                    help="on-disk sweep store (keyed on techlib content "
                         "hash + axes + code salt; default "
                         "REPRO_EXPLORER_CACHE_DIR)")
    ap.add_argument("--device", default=None,
                    help="where the sweeps run, in-process or in the "
                         "--serve service (default: CUDA)")
    args = ap.parse_args(argv)

    minimize = tuple(ax for ax, on in (("vdd", args.minimize_vdd),
                                       ("m", args.minimize_m),
                                       ("tdc_arch", args.minimize_tdc_arch))
                     if on)
    if args.serve:
        serve_argv = ["--host", args.host, "--port", str(args.port)]
        if args.cache_dir:
            serve_argv += ["--cache-dir", args.cache_dir]
        if args.device:
            serve_argv += ["--device", args.device]
        explore_mod.main(serve_argv)
        return None
    if args.query:
        payload = {"op": args.query}
        if args.query in ("sweep", "refine"):
            payload["scenario"] = args.scenario or "paper-relaxed"
            if args.corner:
                payload["corner"] = args.corner
            if args.query == "sweep":
                payload["minimize_over"] = list(minimize)
                if args.crossovers:
                    payload["result"] = "crossovers"
        resp = explore_mod.request(payload, args.host, args.port)
        json.dump(resp, sys.stdout, indent=1)
        sys.stdout.write("\n")
        if not resp.get("ok"):
            raise SystemExit(1)
        return None
    cache_dir = args.cache_dir or os.environ.get("REPRO_EXPLORER_CACHE_DIR")
    svc = explorer_mod.ExplorerService(
        cache_dir=cache_dir or None, device=device_mod.resolve(args.device))
    explorer_mod.set_service(svc)
    sweep_m = _parse_axis("m", args.sweep_m) if args.sweep_m else None
    sweep_tdc = ("hybrid", "sar") if args.sweep_tdc_arch else None
    if args.scenario:
        spec = sc.get_scenario(args.scenario)
        over = {}
        if sweep_m:
            over["ms"] = sweep_m
        if sweep_tdc:
            over["tdc_archs"] = sweep_tdc
        if args.techlib:
            over["techlib"] = args.techlib
        if over:
            spec = spec.replace(**over)
        g = svc.sweep(spec, args.corner, minimize_over=minimize)
    else:
        axes = parse_grid(args.grid)
        sigma = axes["sigma"]
        if sigma is None:
            sigma = (args.sigma,) if args.sigma is not None else None
        corner = sc.get_corner(args.corner)
        spec = sc.Scenario("cli", ns=axes["n"], bit_widths=axes["bits"],
                           sigma_maxes=sigma, vdds=axes["vdd"],
                           p_x_ones=axes["px"], w_bit_sparsities=axes["wsp"],
                           ms=sweep_m or axes["m"],
                           tdc_archs=sweep_tdc or axes["tdc"],
                           techlib=args.techlib or "22fdx")
        g = svc.sweep(spec, corner, minimize_over=minimize)

    if args.format == "table":
        print_winner_map(g, args.metric)
        print_detail(g)
    else:
        recs = list(g.records())
        fh = open(args.out, "w", newline="") if args.out else sys.stdout
        try:
            if args.format == "csv":
                wr = csv.DictWriter(fh, fieldnames=list(recs[0]))
                wr.writeheader()
                wr.writerows(recs)
            else:
                json.dump(recs, fh, indent=1)
                fh.write("\n")
        finally:
            if args.out:
                fh.close()
                print(f"wrote {len(recs)} records to {args.out}",
                      file=sys.stderr)

    if args.crossovers or args.format == "table":
        xs = design_grid.domain_crossovers(g, args.metric)
        print(f"\n{len(xs)} domain crossovers along N ({args.metric}):",
              file=sys.stderr)
        for x in xs[:40]:
            print(f"  B={x['bits']} sigma={x['sigma_max']:.3f} "
                  f"vdd={x['vdd']:.2f} m={x['m']} tdc={x['tdc_arch']}: "
                  f"{x['domain_low']} -> "
                  f"{x['domain_high']} between N={x['n_low']} "
                  f"and N={x['n_high']}", file=sys.stderr)
        if len(xs) > 40:
            print(f"  ... {len(xs) - 40} more", file=sys.stderr)
    return g


if __name__ == "__main__":
    main()
