"""Smoke-size cells for the CPU tests: the cell files' layout at a size
the CPU runs in seconds (the port's plain kernel versions)."""
from __future__ import annotations

import os

from tdbench import harness

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

DENSE = {"name": "smoke-dense", "n_layers": 2, "d_model": 64, "n_heads": 4,
         "n_kv_heads": 2, "head_dim": 16, "d_ff": 160, "vocab": 128,
         "qk_norm": True, "qkv_bias": False, "rope_theta": 1e6,
         "rms_eps": 1e-6, "tie_embeddings": False}
MOE = {**DENSE, "name": "smoke-moe", "qk_norm": False, "rms_eps": 1e-5,
       "moe": {"num_experts": 4, "top_k": 2, "d_ff_expert": 128,
               "capacity_factor": 1.25}}
# the port's exact-regime solve at 4/4 bits and 16-cell chains
TD = {"mode": "td", "bits_a": 4, "bits_w": 4, "n_chain": 16,
      "sigma_max": None}
OP = {"redundancy": 3, "sigma_chain": 0.1554127186536789, "tdc_q": 1}
# the sound program reads 0 on each at this size but for a rare one-ulp
# difference of an attention output (the CPU runs the port's plain
# versions, summed in another order than the reference's)
LIMITS = {"off_best_share": 0.2, "kv_mismatch": 0.2}
# outputs long enough that the requests in the slots at the close have
# served several decode tokens each: the faults' tests judge those
TRAFFIC = {"generator": "closed_loop", "clients": 4, "capacity": 4,
           "prompt_pad": 12, "pool": 8,
           "prompt_len": {"median": 8, "sigma": 0.5, "min": 4, "max": 12},
           "output_len": {"median": 12, "sigma": 0.3, "min": 8, "max": 16},
           "first_output_len": [4, 16]}


def cell(moe: bool = False, check=None, limits=None,
         per_layer: bool = False, traffic=None,
         root: str = ROOT) -> harness.Cell:
    """A smoke cell reporting the real cells' metrics of its kind; its
    generator and metric readers are found under ``root``."""
    bench = harness._read(os.path.join(ROOT, "BENCHMARK.json"))
    kind = "long_output" if moe else "long_prompt"
    like = next(w["name"] for w in bench["workloads"]
                if w["name"].endswith(kind))
    mine = [m for m in bench["end_to_end"]
            if "workloads" not in m or like in m["workloads"]]
    layers = [m for m in bench["per_layer"] if like in m["workloads"]]
    config = {"model_cfg": MOE if moe else DENSE, "td": TD,
              "init": {"std": 0.125, "published_layers": 2},
              "operating_point": OP, "compute_dtype": "bfloat16"}
    chk = check or ({"snapshots": 4, "every": 1} if moe else {"slots": 4})
    return harness.Cell(name="smoke." + kind, config=config,
                        traffic=dict(traffic or TRAFFIC),
                        spec={"check": chk,
                              "limits": limits or LIMITS},
                        end_to_end=mine,
                        per_layer=layers if per_layer else [], root=root)
