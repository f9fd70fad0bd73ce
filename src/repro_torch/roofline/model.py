"""Three-term roofline of the dry run and the serve engine's KV-cache
sizing (port of `repro/roofline/model.py`).

Hardware constants of one NVIDIA H100 SXM5 80GB, from NVIDIA's H100 data
sheet (dense, no sparsity), in place of the reference's TPU v5e-class
ones:

  PEAK_FLOPS  989e12 bf16 FLOP/s (tensor cores)
  PEAK_INT8   1979e12 int8 operations/s (td_vmm's bit planes)
  HBM_BW      3.35e12 B/s
  HBM_BYTES   80e9
  NVLINK_BW   450e9 B/s each way (NVLink 4, 900 GB/s bidirectional)
  IB_BW       50e9 B/s: one 400 Gb/s InfiniBand port a card, the layout of
              a DGX H100 host (eight ConnectX-7 ports for eight cards)

The reference has one link term, ``coll_bytes / (LINK_BW * N_LINKS)``.  On
the port's production mesh (`launch.mesh`: model 8 inside a host, data
and pod across hosts) the collective term is the model axis's link bytes
over NVLink plus the data and pod axes' over InfiniBand:

  compute_s    = flops / PEAK_FLOPS + int8_ops / PEAK_INT8     (per chip)
  memory_s     = bytes / HBM_BW
  collective_s = model_link_bytes / NVLINK_BW
                 + (link_bytes - model_link_bytes) / IB_BW

Every number the dry run derives from these is a model from data-sheet
constants, not a measurement.

`KVCachePlan` / `plan_kv_cache` budget the card the engine runs on:
`device_hbm_bytes` reads the CUDA device's total memory, and a CPU run
plans for an H100 80GB HBM3 (`H100_HBM_BYTES`).
"""
from __future__ import annotations

import dataclasses

import torch

H100_HBM_BYTES = 80e9      # H100 80GB HBM3 data sheet: 80 GB of HBM3
PEAK_FLOPS = 989e12        # bf16 dense tensor-core FLOP/s, H100 SXM
PEAK_INT8 = 1979e12        # int8 dense tensor-core operations/s
HBM_BW = 3.35e12           # B/s
HBM_BYTES = H100_HBM_BYTES
NVLINK_BW = 450e9          # B/s each way a card, NVLink 4
IB_BW = 50e9               # B/s: one 400 Gb/s InfiniBand port a card


@dataclasses.dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    chips: int
    hlo_flops: float           # per chip
    hlo_bytes: float           # per chip
    coll_bytes: float          # per chip (link-model)
    model_flops: float         # 6*N*D (global, fwd+bwd) or serve analogue
    compute_s: float
    memory_s: float
    collective_s: float
    peak_flops: float = PEAK_FLOPS

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def step_s(self) -> float:
        """Roofline step time = max of the three terms (perfect overlap)."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS / (counted FLOPs * chips): remat and replicated work
        show up as a ratio below 1."""
        total = self.hlo_flops * self.chips
        return self.model_flops / total if total else 0.0

    @property
    def mfu(self) -> float:
        """Model FLOPs utilization at the roofline step time."""
        denom = self.step_s * self.chips * self.peak_flops
        return self.model_flops / denom if denom else 0.0


def make_roofline(arch: str, shape: str, mesh: str, chips: int,
                  flops_total: float, bytes_total: float,
                  coll_link_bytes_total: float, model_flops: float, *,
                  coll_model_bytes_total: float = 0.0,
                  int8_ops_total: float = 0.0,
                  peak_flops: float = PEAK_FLOPS, hbm_bw: float = HBM_BW,
                  nvlink_bw: float = NVLINK_BW,
                  ib_bw: float = IB_BW) -> Roofline:
    """Totals are whole-program (all chips); divided down to per chip.
    ``coll_model_bytes_total`` is the part of the link bytes on the model
    axis (NVLink); the rest crosses hosts (InfiniBand)."""
    f = flops_total / chips
    b = bytes_total / chips
    c = coll_link_bytes_total / chips
    c_model = coll_model_bytes_total / chips
    return Roofline(
        arch=arch, shape=shape, mesh=mesh, chips=chips,
        hlo_flops=f, hlo_bytes=b, coll_bytes=c, model_flops=model_flops,
        compute_s=f / peak_flops + int8_ops_total / chips / PEAK_INT8,
        memory_s=b / hbm_bw,
        collective_s=c_model / nvlink_bw + (c - c_model) / ib_bw,
        peak_flops=peak_flops,
    )


def model_flops_train(n_params: float, tokens: float) -> float:
    return 6.0 * n_params * tokens


def model_flops_serve(n_params_active: float, tokens: float) -> float:
    return 2.0 * n_params_active * tokens


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
