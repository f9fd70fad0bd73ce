"""Abstract input stand-ins for every (arch x shape) cell (port of
`repro/launch/specs.py`): the dry run runs the steps on these (fake
tensors, placed as DTensors, no allocation).

Conventions (the reference's, DESIGN.md):
  * train/prefill on decoder archs: tokens/labels (B, S).
  * vlm: 1024 stub patch embeddings replace the first 1024 context
    positions: embeds (B, 1024, d_frontend) + tokens (B, S - 1024).
  * audio enc-dec: the context splits between encoder frames and decoder
    tokens: train -> embeds (B, S/2, d_f) + tokens (B, S/2); prefill_32k ->
    embeds (B, S, d_f) + tokens (B, 2048); decode -> self-cache of S with
    cross memory capped at 8192 frames.
  * decode shapes: one new token against a KV cache/SSM state of length S.

`batch_specs` and `decode_state_shapes` take any mesh (a `DeviceMesh` or
a duck-typed one) and return `Abstract` leaves (shape, dtype, spec) and
fake tensors; `materialize` and `decode_input_specs` turn them into fake
DTensors on a `DeviceMesh`.
"""
from __future__ import annotations

import contextlib
import dataclasses

import torch

from repro_torch.configs import ArchConfig
from repro_torch.configs.base import ShapeCfg
from repro_torch.launch import sharding as shard_lib

TOKEN_DT = torch.int32
EMBED_DT = torch.bfloat16
CACHE_DT = torch.bfloat16

N_PATCHES = 1024
CROSS_MEMORY_CAP = 8192
DEC_PREFILL = 2048


@dataclasses.dataclass(frozen=True)
class Abstract:
    """A tensor's shape, dtype and spec: the port's ShapeDtypeStruct."""
    shape: tuple
    dtype: torch.dtype
    spec: tuple


def fake_mode():
    """The active `FakeTensorMode`, or a new one to enter."""
    from torch._guards import detect_fake_mode
    from torch._subclasses.fake_tensor import FakeTensorMode
    if detect_fake_mode() is not None:
        return contextlib.nullcontext()
    return FakeTensorMode()


def _vis_positions(cfg, s: int) -> int:
    return min(N_PATCHES, max(s // 4, 16))


def batch_specs(arch: ArchConfig, shape: ShapeCfg, mesh,
                batch: int | None = None) -> dict:
    """Inputs of train/prefill steps; ``batch`` overrides the shape's
    global batch (the dry run's microbatch)."""
    cfg = arch.model
    b, s = batch or shape.global_batch, shape.seq_len
    bs = shard_lib.batch_spec(mesh, b, 2)
    bs3 = shard_lib.batch_spec(mesh, b, 3)
    if cfg.family == "encdec":
        if shape.kind == "train":
            s_src, s_tgt = s // 2, s // 2
        else:                     # prefill: seq_len on the encoder
            s_src, s_tgt = s, DEC_PREFILL
        return {
            "embeds": Abstract((b, s_src, cfg.d_frontend), EMBED_DT, bs3),
            "tokens": Abstract((b, s_tgt), TOKEN_DT, bs),
            "labels": Abstract((b, s_tgt), TOKEN_DT, bs),
        }
    out = {}
    s_txt = s
    if cfg.frontend is not None:
        n_vis = _vis_positions(cfg, s)
        s_txt = s - n_vis
        out["embeds"] = Abstract((b, n_vis, cfg.d_frontend), EMBED_DT, bs3)
    out["tokens"] = Abstract((b, s_txt), TOKEN_DT, bs)
    out["labels"] = Abstract((b, s_txt), TOKEN_DT, bs)
    return out


def materialize(tree, mesh):
    """Fake DTensors for a tree of `Abstract` leaves on ``mesh``."""
    from torch.distributed.tensor import distribute_tensor

    def make(a):
        with fake_mode():
            t = torch.zeros(a.shape, dtype=a.dtype)
            return distribute_tensor(t, mesh,
                                     shard_lib.placements(a.spec, mesh),
                                     src_data_rank=None)
    return {k: make(v) for k, v in tree.items()}


def decode_state_shapes(arch: ArchConfig, shape: ShapeCfg) -> dict:
    """The decode-state tree as fake tensors (no allocation; called with
    no mesh active): {"layers": caches, "enc_out": None or (B, 8192,
    d)}."""
    from repro_torch.models import encdec, transformer
    cfg = arch.model
    b, s = shape.global_batch, shape.seq_len
    with fake_mode():
        if cfg.family == "encdec":
            caches = encdec.init_caches(b, s, cfg, CACHE_DT, "cpu")
            enc_out = torch.zeros((b, CROSS_MEMORY_CAP, cfg.d_model),
                                  dtype=EMBED_DT)
            return {"layers": caches, "enc_out": enc_out}
        caches = transformer.init_caches(b, s, cfg, CACHE_DT, "cpu")
        return {"layers": caches, "enc_out": None}


def decode_input_specs(arch: ArchConfig, shape: ShapeCfg, mesh) -> dict:
    """Inputs of the serve (decode) step: one token and the state, fake
    DTensors placed by `cache_specs` and `batch_spec`."""
    b = shape.global_batch
    state = decode_state_shapes(arch, shape)
    specs = shard_lib.cache_specs(state, mesh)
    with fake_mode():
        state = shard_lib.distribute(state, specs, mesh)
    tok = materialize({"tok": Abstract(
        (b, 1), TOKEN_DT, shard_lib.batch_spec(mesh, b, 2))}, mesh)["tok"]
    return {"tok": tok, "state": state}
