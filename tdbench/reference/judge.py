"""The comparison that decides ``correct``, and its control.

The number compared is the widest gap by which a served token's logit
lies below the reference's best at the same position: 0 where the engine
served the reference's first choice (or a tie of it).  The control is the
reference itself at the next precision below the configuration's bf16:
every bf16 rounding point of the model rounds to float8 e4m3 with a
per-row scale instead; its first choice at each position is read under
the reference's logits the same way.
"""
from __future__ import annotations

import torch

F8_MAX = 448.0


def fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 with one scale per row (its last dim's
    largest magnitude at the format's largest finite value), returned in
    ``t``'s dtype."""
    f = t.to(torch.float32)
    amax = f.abs().amax(-1, keepdim=True).clamp(min=1e-30)
    s = amax / F8_MAX
    return ((f / s).to(torch.float8_e4m3fn).to(torch.float32) * s).to(t.dtype)


def gaps(ref_logits: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """(J,) float32: the reference's best logit minus its logit of each
    row's token."""
    f = ref_logits.to(torch.float32)
    return f.amax(-1) - f.gather(1, tokens[:, None].to(torch.int64))[:, 0]
