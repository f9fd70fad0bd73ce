"""Entry point of the flash-attention engine (port of
`repro/kernels/flash_attn/ops.py`): the fused kernel forward and a
recompute backward.

The forward never materializes the (Sq, Skv) score matrix (it runs
`flash_attn`, the CUDA kernel on CUDA tensors); the backward recomputes
attention with a q-chunked differentiable masked softmax
(`_attn_recompute`, plain torch as the reference's is jnp) and takes its
gradient, so the residuals are just (q, k, v).  ``kv_len`` / ``q_offset``
are integer runtime operands and get no gradient.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.attn_common import NEG_INF
from repro_torch.kernels.flash_attn.flash_attn import flash_attn


def _masked_attn(q, k, v, kv_len, q_offset, causal: bool):
    """Differentiable masked-softmax attention, f32 math (backward only:
    the forward path is the fused kernel)."""
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    qg = q.reshape(b, sq, hkv, g, d).to(torch.float32) * (d ** -0.5)
    sc = torch.einsum("bskgd,btkd->bkgst", qg, k.to(torch.float32))
    kpos = torch.arange(skv, device=q.device)
    mask = (kpos[None, :] < kv_len[:, None])[:, None, None, None, :]
    if causal:
        qpos = q_offset.reshape(()) + torch.arange(sq, device=q.device)
        mask = mask & (qpos[:, None] >= kpos[None, :])[None, None, None]
    sc = torch.where(mask, sc, NEG_INF)
    p = torch.exp(sc - sc.amax(-1, keepdim=True).detach())
    p = torch.where(mask, p, 0.0)
    p = p / torch.clamp(p.sum(-1, keepdim=True), min=1e-30)
    o = torch.einsum("bkgst,btkd->bskgd", p, v.to(torch.float32))
    return o.reshape(b, sq, hq, d).to(q.dtype)


def _q_chunk(sq: int, cap: int = 512) -> int:
    """Largest divisor of sq that is <= cap (bounds the bwd score buffer)."""
    for c in range(min(sq, cap), 0, -1):
        if sq % c == 0:
            return c
    return sq


def _attn_recompute(causal: bool, q, k, v, kv_len, q_offset,
                    cap: int = 512):
    """Masked attention recompute, chunked over the query axis so the
    backward's transient score buffer is (B, Hq, cq, Skv), not Sq x Skv."""
    sq = q.shape[1]
    cq = _q_chunk(sq, cap)
    if cq == sq:
        return _masked_attn(q, k, v, kv_len, q_offset, causal)
    return torch.cat([_masked_attn(q[:, i:i + cq], k, v, kv_len,
                                   q_offset + i, causal)
                      for i in range(0, sq, cq)], dim=1)


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, kv_len, q_offset, causal):
        ctx.save_for_backward(q, k, v, kv_len, q_offset)
        ctx.causal = causal
        return flash_attn(q, k, v, kv_len, q_offset, causal=causal)

    @staticmethod
    def backward(ctx, g):
        q, k, v, kv_len, q_offset = ctx.saved_tensors
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_() for t in (q, k, v)]
            o = _attn_recompute(ctx.causal, *leaves, kv_len, q_offset)
            gq, gk, gv = torch.autograd.grad(o, leaves, g.to(q.dtype))
        return gq, gk, gv, None, None, None


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
    return _FlashAttention.apply(q, k, v, kv_len.to(torch.int32),
                                 q_offset.reshape(1).to(torch.int32), causal)
