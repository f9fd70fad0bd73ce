"""Entry point of the decode attention engine (port of
`repro/kernels/decode_gqa/ops.py`)."""
from __future__ import annotations

import torch

from repro_torch.kernels.decode_gqa.decode_gqa import decode_gqa


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     length: torch.Tensor) -> torch.Tensor:
    """q (B, Hq, D); k/v (B, S, Hkv, D); length (B,) int32 -> (B, Hq, D)."""
    return decode_gqa(q, k, v, length.to(torch.int32))
