"""Entry point of the fused LSQ fake-quant kernel (port of
`repro/kernels/lsq_quant/ops.py`): forward only; `quant.lsq` attaches the
LSQ gradient rules."""
from __future__ import annotations

import torch

from repro_torch.kernels.lsq_quant.lsq_quant import lsq_quant as _lsq_quant
from repro_torch.quant.lsq import qrange


def lsq_quant(x: torch.Tensor, s: torch.Tensor, bits: int,
              signed: bool) -> torch.Tensor:
    qn, qp = qrange(bits, signed)
    return _lsq_quant(x, s, qn, qp)
