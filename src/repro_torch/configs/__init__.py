"""Architecture registry of the port: `--arch <id>` resolution.

Every architecture of the reference's registry: the dense decoders
``qwen3-8b``, ``granite-8b``, ``qwen2.5-3b`` and ``qwen3-4b``, the MoE
decoders ``granite-moe-1b-a400m`` and ``dbrx-132b``, the vision-frontend
decoder ``internvl2-26b`` (a stub frontend: precomputed patch embeddings
through an adapter), the encoder-decoder ``seamless-m4t-large-v2`` (a
stub audio frontend), the mamba2 / shared attention hybrid
``zamba2-1.2b`` and the attention-free ``rwkv6-1.6b``.  An unknown name
raises `KeyError`, as the reference's `get` does.
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import (ArchConfig, ModelCfg, MoECfg, RWKVCfg,
                                      SHAPES, SSMCfg, ShapeCfg, TDExecCfg,
                                      TrainCfg)

_MODULES = {
    "dbrx-132b": "repro_torch.configs.dbrx_132b",
    "granite-8b": "repro_torch.configs.granite_8b",
    "granite-moe-1b-a400m": "repro_torch.configs.granite_moe_1b",
    "internvl2-26b": "repro_torch.configs.internvl2_26b",
    "qwen2.5-3b": "repro_torch.configs.qwen2_5_3b",
    "qwen3-4b": "repro_torch.configs.qwen3_4b",
    "qwen3-8b": "repro_torch.configs.qwen3_8b",
    "rwkv6-1.6b": "repro_torch.configs.rwkv6_1_6b",
    "seamless-m4t-large-v2": "repro_torch.configs.seamless_m4t_large_v2",
    "zamba2-1.2b": "repro_torch.configs.zamba2_1_2b",
}

ARCH_NAMES = ("granite-8b", "qwen2.5-3b", "qwen3-8b", "qwen3-4b",
              "internvl2-26b", "seamless-m4t-large-v2", "dbrx-132b",
              "granite-moe-1b-a400m", "zamba2-1.2b", "rwkv6-1.6b")

# pure full-attention archs skip the long_500k cell (sub-quadratic required)
LONG_CONTEXT_ARCHS = ("zamba2-1.2b", "rwkv6-1.6b")


def _module(name: str):
    return importlib.import_module(_MODULES[name])


def get(name: str) -> ArchConfig:
    return _module(name).CONFIG


def get_smoke(name: str) -> ArchConfig:
    return _module(name).smoke()


def cells(include_skips: bool = True):
    """All 40 (arch x shape) cells in the reference's order, as (arch,
    shape, skipped): long_500k is skipped on every arch outside
    `LONG_CONTEXT_ARCHS`, which leaves 34."""
    out = []
    for a in ARCH_NAMES:
        for s in SHAPES.values():
            skip = (s.name == "long_500k" and a not in LONG_CONTEXT_ARCHS)
            if include_skips or not skip:
                out.append((a, s.name, skip))
    return out


__all__ = ["ArchConfig", "ModelCfg", "MoECfg", "RWKVCfg", "SSMCfg",
           "ShapeCfg", "TDExecCfg", "TrainCfg", "SHAPES", "ARCH_NAMES",
           "LONG_CONTEXT_ARCHS", "get", "get_smoke", "cells"]
