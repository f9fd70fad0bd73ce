"""Shared plumbing of the attention kernels' wrappers (port of
`repro/kernels/attn_common.py`): the masking constant and operand checks."""
from __future__ import annotations

import torch

NEG_INF = -1e30

DTYPE_FLAG = {torch.float32: 0, torch.bfloat16: 1}


def check_float(name: str, *ts: torch.Tensor) -> None:
    for t in ts:
        if t.dtype not in DTYPE_FLAG:
            raise TypeError(f"{name} takes float32 or bfloat16, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} wants contiguous operands")


def check_index(name: str, t: torch.Tensor, n: int, device) -> None:
    if t.dtype != torch.int32 or t.numel() != n or t.device != device:
        raise ValueError(f"{name}: runtime operand must be {n} int32 "
                         f"value(s) on {device}, got {t.dtype} "
                         f"{tuple(t.shape)} on {t.device}")


def softmax_rows(sc: torch.Tensor, mask: torch.Tensor, v_fn) -> torch.Tensor:
    """Masked softmax-weighted sum with the kernels' numerics: masked
    scores NEG_INF, masked probabilities zeroed, acc / max(l, 1e-30)."""
    sc = torch.where(mask, sc, NEG_INF)
    m = sc.amax(-1, keepdim=True)
    p = torch.where(mask, torch.exp(sc - m), 0.0)
    l = p.sum(-1, keepdim=True)
    return v_fn(p) / torch.clamp(l, min=1e-30)
