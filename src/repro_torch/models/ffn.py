"""SwiGLU dense MLP (port of the dense half of `repro/models/ffn.py`; the
MoE FFN comes with the other families)."""
from __future__ import annotations

import torch

from repro_torch.models import common


def swiglu_init(gen: torch.Generator, d: int, d_ff: int, pol,
                dtype=torch.float32, device=None) -> dict:
    return {"wi": common.dense_init(gen, d, d_ff, pol, dtype=dtype,
                                    device=device),
            "wg": common.dense_init(gen, d, d_ff, pol, dtype=dtype,
                                    device=device),
            "wo": common.dense_init(gen, d_ff, d, pol, dtype=dtype,
                                    scale=1.0 / d_ff ** 0.5, device=device)}


def silu(x: torch.Tensor) -> torch.Tensor:
    """x * (1 / (1 + exp(-x))), one rounding per op in x's dtype: the
    expansion of the reference's ``jax.nn.silu``.  In bf16 it agrees with
    the reference bit for bit, where ``F.silu`` (one rounding) does not."""
    return x * (1.0 / (1.0 + torch.exp(-x)))


def swiglu(params: dict, x: torch.Tensor, pol, key=None) -> torch.Tensor:
    k1, k2, k3 = (common.fold_key(key, i) for i in range(3))
    h = silu(common.dense(params["wg"], x, pol, k1)) \
        * common.dense(params["wi"], x, pol, k2)
    return common.dense(params["wo"], h, pol, k3)
