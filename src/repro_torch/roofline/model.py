"""KV-cache sizing of the continuous-batching serve engine (port of
`KVCachePlan` and `plan_kv_cache` of `repro/roofline/model.py`).

The reference budgets a TPU's 16 GB; the port budgets the card it runs on:
`device_hbm_bytes` reads the CUDA device's total memory, and a CPU run
plans for an H100 80GB HBM3 (`H100_HBM_BYTES`).  The reference's dry-run
roofline (`Roofline`, its TPU constants) is not ported.
"""
from __future__ import annotations

import dataclasses

import torch

H100_HBM_BYTES = 80e9      # H100 80GB HBM3 data sheet: 80 GB of HBM3


def device_hbm_bytes(device) -> float:
    """Device memory of ``device`` in bytes: the card's own total on CUDA,
    `H100_HBM_BYTES` (the card the port is built for) on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda":
        return float(torch.cuda.get_device_properties(dev).total_memory)
    return H100_HBM_BYTES


@dataclasses.dataclass(frozen=True)
class KVCachePlan:
    """Block-granular KV-cache sizing for the slot-batched serve engine.

    Slots are contiguous per request but sized in `block`-token blocks
    against a memory budget (a fraction of the device's capacity net of
    weights).  `max_slots` is how many slots of `s_cache` tokens the
    budget admits; `fits` says whether the requested capacity does.
    """
    capacity: int              # requested concurrent slots
    s_cache: int               # tokens per slot, rounded up to blocks
    block: int                 # allocation granularity (tokens)
    bytes_per_slot: int
    bytes_total: int           # capacity * bytes_per_slot
    budget_bytes: int
    max_slots: int

    @property
    def fits(self) -> bool:
        return self.capacity <= self.max_slots


def plan_kv_cache(cfg, capacity: int, s_cache: int, *, block: int = 128,
                  dtype_bytes: int = 2, weight_bytes: float = 0.0,
                  budget_frac: float = 0.9,
                  hbm_bytes: float = H100_HBM_BYTES) -> KVCachePlan:
    """Size the serve engine's KV slots against the device memory.

    cfg: a ModelCfg (uses n_layers/mixer pattern/n_kv_heads/hd).  The
    budget is `budget_frac` of (hbm_bytes - weight_bytes); per-slot bytes
    are K+V per attention layer at `dtype_bytes` per element, with the
    sequence rounded up to `block`-token blocks.
    """
    n_attn = sum(1 for i in range(cfg.n_layers)
                 if cfg.mixer_at(i) in ("attn", "shared_attn"))
    blocks = max(1, -(-s_cache // block))
    s_pad = blocks * block
    per_slot = 2 * n_attn * s_pad * cfg.n_kv_heads * cfg.hd * dtype_bytes
    budget = max(0.0, (hbm_bytes - weight_bytes)) * budget_frac
    max_slots = int(budget // per_slot) if per_slot else 0
    return KVCachePlan(capacity=capacity, s_cache=s_pad, block=block,
                       bytes_per_slot=per_slot,
                       bytes_total=capacity * per_slot,
                       budget_bytes=int(budget), max_slots=max_slots)
