"""Plain PyTorch version of the fused LSQ fake-quant kernel (port of
`repro/kernels/lsq_quant/ref.py`).  The CPU path and the tests run it;
`chip_smoke.py` holds the CUDA kernel against it on the card."""
from __future__ import annotations

import torch


def lsq_quant_ref(x: torch.Tensor, s: torch.Tensor, qn: float,
                  qp: float) -> torch.Tensor:
    """clip(round(x / max(s, 1e-8)), qn, qp) * max(s, 1e-8), each op in
    x's dtype (x and s share it); round is half to even and a NaN stays
    NaN, as in the reference."""
    s_ = torch.clamp(s, min=1e-8)
    r = torch.clamp(torch.round(x / s_), qn, qp)
    if qn == 0:
        # jnp.clip's max(-0, 0) is +0; torch.clamp keeps -0
        r = r + 0.0
    return r * s_
