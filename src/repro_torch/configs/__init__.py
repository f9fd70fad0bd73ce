"""Architecture registry of the port: `--arch <id>` resolution.

The dense decoders ``qwen3-8b``, ``granite-8b``, ``qwen2.5-3b`` and
``qwen3-4b`` and the MoE decoder ``granite-moe-1b-a400m`` are ported so
far (ROADMAP §1 step 13 lists the other families); any other name
raises.
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import (ArchConfig, ModelCfg, MoECfg, RWKVCfg,
                                      SHAPES, SSMCfg, ShapeCfg, TDExecCfg,
                                      TrainCfg)

_MODULES = {
    "granite-8b": "repro_torch.configs.granite_8b",
    "granite-moe-1b-a400m": "repro_torch.configs.granite_moe_1b",
    "qwen2.5-3b": "repro_torch.configs.qwen2_5_3b",
    "qwen3-4b": "repro_torch.configs.qwen3_4b",
    "qwen3-8b": "repro_torch.configs.qwen3_8b",
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
