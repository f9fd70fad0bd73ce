"""CLI plumbing shared by the train and serve CLIs (port of
`repro/launch/td_cli.py`): ``--td``, heterogeneous per-layer TD execution
(``--td-per-layer``) and the ``--scenario`` / ``--corner`` operating point.

`--td-per-layer` accepts either

  * an inline comma-separated sigma_array_max list, one entry per model
    layer (a single value broadcasts), e.g. ``--td-per-layer 0.5,1.0,2.0``
    -- "exact" marks the exact regime (sigma_max=None) for that layer;
  * ``@path/to/per_layer_policies.json``: ``{"layers": [{"sigma_max": ..,
    "n_chain": ..?, "bits_w": ..?}, ...]}`` or a bare list of such
    records (the reference's noise-tolerance search writes this artifact).
    Missing fields inherit from the base ``TDExecCfg``.
"""
from __future__ import annotations

import dataclasses
import json

from repro_torch.configs.base import ArchConfig, TDExecCfg
from repro_torch.core import scenario as scenario_mod


def _parse_sigma_token(tok: str) -> float | None:
    tok = tok.strip()
    if tok.lower() in ("exact", "none"):
        return None
    return float(tok)


def parse_td_per_layer(spec: str, base: TDExecCfg,
                       n_layers: int) -> tuple[TDExecCfg, ...]:
    """Spec string -> one "td"-mode TDExecCfg per layer."""
    base = dataclasses.replace(base, mode="td")
    if spec.startswith("@"):
        with open(spec[1:]) as f:
            doc = json.load(f)
        records = doc["layers"] if isinstance(doc, dict) else doc
        if len(records) == 1:
            records = list(records) * n_layers
        if len(records) != n_layers:
            raise ValueError(f"{spec[1:]} has {len(records)} layer records, "
                             f"model has {n_layers} layers")
        out = []
        for rec in records:
            kw = {k: rec[k] for k in ("bits_a", "bits_w", "n_chain")
                  if k in rec}
            out.append(dataclasses.replace(base,
                                           sigma_max=rec.get("sigma_max"),
                                           **kw))
        return tuple(out)
    sigmas = [_parse_sigma_token(t) for t in spec.split(",") if t.strip()]
    if len(sigmas) == 1:
        sigmas = sigmas * n_layers
    if len(sigmas) != n_layers:
        raise ValueError(f"--td-per-layer gave {len(sigmas)} sigmas, model "
                         f"has {n_layers} layers")
    return tuple(dataclasses.replace(base, sigma_max=s) for s in sigmas)


def apply_td_args(arch: ArchConfig, td: str | None,
                  td_per_layer: str | None = None,
                  scenario: str | None = None,
                  corner: str | None = None,
                  td_attn: str | None = None) -> ArchConfig:
    """Shared --td / --td-per-layer / --td-attn / --scenario / --corner
    handling for the train/serve CLIs.  Scenario/corner names are validated
    against the core.scenario registries here so a typo fails at the CLI,
    not inside the first policy solve."""
    if td:
        arch = arch.replace(td=TDExecCfg(mode=td, n_chain=min(
            576, arch.model.d_model)))
    if td_per_layer:
        base = arch.td if arch.td.mode == "td" else TDExecCfg(
            mode="td", n_chain=min(576, arch.model.d_model))
        arch = arch.replace(td_per_layer=parse_td_per_layer(
            td_per_layer, base, arch.model.n_layers))
    if td_attn:
        # chain length clamps to the head dim (the QK contraction) inside
        # resolve_arch_policy; the cfg just carries the requested mode
        arch = arch.replace(td_attn=TDExecCfg(mode=td_attn, n_chain=min(
            576, arch.model.hd)))
    if scenario or corner:
        if scenario:
            scenario_mod.get_scenario(scenario)
        scenario_mod.get_corner(corner)
        arch = arch.replace(scenario=scenario or "vdd-opt", corner=corner)
    return arch


def add_td_attn_arg(ap) -> None:
    """Register the shared --td-attn argparse flag."""
    ap.add_argument("--td-attn", default=None, choices=["quant", "td"],
                    help="route attention QK^T/PV through the TD engine "
                    "under per-head policies resolved from the scenario "
                    "grid (decoder-family models only)")


def add_scenario_args(ap) -> None:
    """Register the shared --scenario/--corner argparse flags."""
    ap.add_argument("--scenario", default=None,
                    help="named design scenario (core.scenario.SCENARIOS) "
                    "to resolve TD operating points for: corner-derated "
                    "error budgets, grid-argmin supply per matmul")
    ap.add_argument("--corner", default=None,
                    help="technology corner preset (tt/ff/ss); implies the "
                    "default 'vdd-opt' scenario when --scenario is absent")
