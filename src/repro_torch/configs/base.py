"""Config system: model / parallelism / training / TD-execution configs.

The port's own copy of `repro/configs/base.py` (the port imports nothing
of `repro`); the dataclasses and their defaults are identical.

Every assigned architecture ships one file in this package defining
`CONFIG: ArchConfig` with the exact public-literature dimensions, plus a
`smoke()` reduced config of the same family for CPU tests.

`--arch <id>` resolution goes through `registry.get(name)`.
"""
from __future__ import annotations

import dataclasses
from typing import Literal

Family = Literal["decoder", "encdec"]
Mixer = Literal["attn", "mamba2", "rwkv6", "shared_attn"]


@dataclasses.dataclass(frozen=True)
class MoECfg:
    num_experts: int
    top_k: int
    d_ff_expert: int
    capacity_factor: float = 1.25
    router_z_coef: float = 1e-3
    aux_coef: float = 1e-2


@dataclasses.dataclass(frozen=True)
class SSMCfg:
    d_state: int = 64
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    chunk: int = 128         # SSD chunk length


@dataclasses.dataclass(frozen=True)
class RWKVCfg:
    head_dim: int = 64
    decay_lora: int = 64     # rank of the data-dependent decay LoRA
    mix_lora: int = 32       # rank of the token-shift mix LoRA


@dataclasses.dataclass(frozen=True)
class TDExecCfg:
    """How (and whether) matmuls run through the TD execution simulator."""
    mode: str = "precise"            # precise | quant | td
    bits_a: int = 4
    bits_w: int = 4
    n_chain: int = 576               # hardware chain length (paper baseline)
    sigma_max: float | None = None   # None = exact regime


@dataclasses.dataclass(frozen=True)
class ModelCfg:
    name: str
    family: Family = "decoder"
    n_layers: int = 4
    d_model: int = 256
    n_heads: int = 4
    n_kv_heads: int = 4
    d_ff: int = 1024
    vocab: int = 1024
    head_dim: int | None = None      # defaults to d_model // n_heads
    qk_norm: bool = False            # qwen3
    qkv_bias: bool = False           # qwen2.5
    rope_theta: float = 1e6
    rms_eps: float = 1e-5
    tie_embeddings: bool = False
    moe: MoECfg | None = None
    ssm: SSMCfg | None = None
    rwkv: RWKVCfg | None = None
    # per-layer mixer pattern; None = all "attn".  For hybrids, a tuple of
    # Mixer strings of length n_layers ("shared_attn" reuses tied weights).
    layer_pattern: tuple[str, ...] | None = None
    # per-layer ffn pattern ("swiglu"|"moe"|"rwkv_cm"|"none"); None = derived
    ffn_pattern: tuple[str, ...] | None = None
    # encoder (enc-dec family only)
    n_enc_layers: int = 0
    enc_bidirectional: bool = True
    cross_attn_every: int = 1
    # modality frontend stubs: number of precomputed embedding positions the
    # input_specs provide (vlm patches / audio frames)
    frontend: str | None = None      # None | "vision" | "audio"
    d_frontend: int = 0              # stub embedding dim (0 = d_model)
    # compile-time: scan over (homogeneous) layers instead of unrolling —
    # shrinks HLO ~L x; cost_analysis then reports the body once (the
    # roofline table therefore uses unrolled lowers; see DESIGN.md §6)
    scan_layers: bool = False
    # sub-quadratic? (pure full-attention archs skip long_500k)
    subquadratic: bool = False

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    def mixer_at(self, i: int) -> str:
        if self.layer_pattern is None:
            return "attn"
        return self.layer_pattern[i]


@dataclasses.dataclass(frozen=True)
class TrainCfg:
    lr: float = 3e-4
    warmup: int = 100
    total_steps: int = 1000
    weight_decay: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    grad_clip: float = 1.0
    n_microbatches: int = 1
    zero1: bool = True               # shard optimizer state over 'data'
    remat: str = "full"              # none | dots | full
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    grad_allreduce_dtype: str = "float32"   # bfloat16 = compressed grads
    seed: int = 0


@dataclasses.dataclass(frozen=True)
class ShapeCfg:
    """One of the assigned input-shape cells."""
    name: str
    seq_len: int
    global_batch: int
    kind: str                        # train | prefill | decode


SHAPES = {
    "train_4k": ShapeCfg("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeCfg("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeCfg("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeCfg("long_500k", 524288, 1, "decode"),
}


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    model: ModelCfg
    train: TrainCfg = TrainCfg()
    td: TDExecCfg = TDExecCfg()
    # heterogeneous per-layer TD execution (one TDExecCfg per model layer,
    # e.g. sigma_max back-annotated per layer by the Fig. 10 batched search);
    # None = the single `td` config applies everywhere.  `td` still drives
    # the shared top-level matmuls (adapter / lm_head).
    td_per_layer: tuple[TDExecCfg, ...] | None = None
    # TD-quantized attention: route every layer's QK^T / PV contractions
    # through the td_vmm engine under per-head policies resolved from the
    # grid (tdsim.td_attention).  None = precise attention on the fused
    # flash/decode kernels.  Decoder-family models only (like td_per_layer).
    td_attn: TDExecCfg | None = None
    # named design scenario / technology corner the TD policies resolve for
    # (core.scenario registries): the corner derates error budgets and
    # shifts the supply grid, and each "td"-mode matmul's Vdd is picked by
    # the scenario grid argmin.  None = nominal supply, TT corner.
    scenario: str | None = None
    corner: str | None = None
    # per-shape microbatch override: {shape_name: n_microbatches}
    microbatch_by_shape: dict | None = None

    def microbatches_for(self, shape: str) -> int:
        if self.microbatch_by_shape and shape in self.microbatch_by_shape:
            return self.microbatch_by_shape[shape]
        return self.train.n_microbatches

    def replace(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)
