"""Entry point of the flash-attention engine (port of the forward of
`repro/kernels/flash_attn/ops.py`).  The recompute backward
(`_attn_recompute`) comes with the training slice."""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attn.flash_attn import flash_attn


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    kv_len: torch.Tensor | None = None,
                    q_offset: torch.Tensor | None = None, *,
                    causal: bool = True) -> torch.Tensor:
    """q (B, Sq, Hq, D); k/v (B, Skv, Hkv, D) -> (B, Sq, Hq, D).
    ``kv_len`` (B,) int32 valid KV prefix per row (default: all of Skv);
    ``q_offset`` int32 position of query row 0 (default 0)."""
    b, skv = q.shape[0], k.shape[1]
    if kv_len is None:
        kv_len = torch.full((b,), skv, dtype=torch.int32, device=q.device)
    if q_offset is None:
        q_offset = torch.zeros((1,), dtype=torch.int32, device=q.device)
    return flash_attn(q, k, v, kv_len.to(torch.int32),
                      q_offset.reshape(1).to(torch.int32), causal=causal)
