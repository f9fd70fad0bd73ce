"""The ``--td`` flag shared by the train and serve CLIs (port of the
``--td`` part of `repro/launch/td_cli.apply_td_args`; its other flags are
not ported and the CLIs reject them)."""
from __future__ import annotations

from repro_torch.configs.base import ArchConfig, TDExecCfg


def apply_td_args(arch: ArchConfig, td: str | None) -> ArchConfig:
    """``--td MODE``: one TD execution config for every matmul, with the
    chain length clamped to d_model."""
    if td:
        arch = arch.replace(td=TDExecCfg(mode=td, n_chain=min(
            576, arch.model.d_model)))
    return arch
