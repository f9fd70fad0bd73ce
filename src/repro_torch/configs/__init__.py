"""Architecture registry of the port: `--arch <id>` resolution.

The dense decoders ``qwen3-8b``, ``granite-8b``, ``qwen2.5-3b`` and
``qwen3-4b``, the MoE decoder ``granite-moe-1b-a400m``, the
vision-frontend decoder ``internvl2-26b`` (a stub frontend: precomputed
patch embeddings through an adapter) and the encoder-decoder
``seamless-m4t-large-v2`` (a stub audio frontend) are ported so far;
``dbrx-132b``, ``zamba2-1.2b`` and ``rwkv6-1.6b`` raise (ROADMAP §1 step
13 lists them).
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import (ArchConfig, ModelCfg, MoECfg, RWKVCfg,
                                      SHAPES, SSMCfg, ShapeCfg, TDExecCfg,
                                      TrainCfg)

_MODULES = {
    "granite-8b": "repro_torch.configs.granite_8b",
    "granite-moe-1b-a400m": "repro_torch.configs.granite_moe_1b",
    "internvl2-26b": "repro_torch.configs.internvl2_26b",
    "qwen2.5-3b": "repro_torch.configs.qwen2_5_3b",
    "qwen3-4b": "repro_torch.configs.qwen3_4b",
    "qwen3-8b": "repro_torch.configs.qwen3_8b",
    "seamless-m4t-large-v2": "repro_torch.configs.seamless_m4t_large_v2",
}

ARCH_NAMES = tuple(_MODULES)


def _module(name: str):
    if name not in _MODULES:
        raise NotImplementedError(
            f"arch {name!r} is not yet ported to repro_torch (ported: "
            f"{', '.join(ARCH_NAMES)}; see ROADMAP.md §1)")
    return importlib.import_module(_MODULES[name])


def get(name: str) -> ArchConfig:
    return _module(name).CONFIG


def get_smoke(name: str) -> ArchConfig:
    return _module(name).smoke()


__all__ = ["ArchConfig", "ModelCfg", "MoECfg", "RWKVCfg", "SSMCfg",
           "ShapeCfg", "TDExecCfg", "TrainCfg", "SHAPES", "ARCH_NAMES",
           "get", "get_smoke"]
