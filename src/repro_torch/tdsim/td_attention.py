"""TD-simulated attention: QK^T and PV through the td_vmm engine under
per-head policies (port of `repro/tdsim/td_attention.py`).

Pipeline (mode "td" / "quant"):
  1. Quantize q per (batch, q-head) at bits_a and k per (batch, kv-head)
     at bits_w, symmetric maxabs over the whole (S, D) block (`_quant_dyn`;
     with a KV cache that is the whole cache, not only its valid prefix).
  2. QK^T: one td_vmm lane call over B * Hq lanes (lane = b * Hq + h): x is
     the lane's q codes (Sq, D), w its kv-head's k codes transposed
     (D, Skv), one w a lane; each lane carries its head's (sigma_chain,
     tdc_q) and the seed ``hash32(seed ^ lane)``.
  3. Dequantize as ``sc * s_q * s_k * D^-0.5`` (in that order), mask
     (valid-KV prefix, and causal at ``q_offset``) and take the softmax in
     f32: digital post-processing, not a VMM.  Masked entries are 0.
  4. Quantize the probabilities per (batch, q-head) at bits_a and v per
     (batch, kv-head) at bits_w; PV is a second lane call with the seeds
     ``hash32(seed ^ lane ^ GOLDEN)``, K = Skv over chains of n_chain.
  5. Dequantize.  Gradients are straight-through (`_TDAttentionSTE`): the
     backward is autograd through the clean masked-softmax attention in
     f32 (`kernels.flash_attn.ops._masked_attn`, the reference's
     `_clean_attention`), recomputed there; sigma, tdc_q, kv_len, q_offset
     and the seed get none.

On CUDA tensors the lane calls launch the td_vmm kernel (two launches a
call); on CPU tensors they run its plain version.  All heads share (mode,
bits_a, bits_w, n_chain); (R, sigma_chain, tdc_q) are free per head.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.attn_common import attn_mask, masked_softmax
from repro_torch.kernels.flash_attn.ops import _masked_attn
from repro_torch.kernels.td_vmm import ops as td_ops
from repro_torch.kernels.td_vmm import ref as td_ref
from repro_torch.tdsim.policy import TDPolicy

_PV_SALT = td_ref.GOLDEN


def _quant_dyn(x: torch.Tensor, bits: int,
               dims) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric maxabs quantization to signed int32 codes over ``dims``:
    (codes, step) with step = max|x| / (2^(bits-1) - 1), at least 1e-8."""
    levels = 2 ** (bits - 1) - 1
    # divided by a device tensor: CUDA divides by a host scalar as a
    # multiply by its reciprocal, an ulp off the reference's division
    s = torch.amax(torch.abs(x), dim=dims, keepdim=True) / torch.full(
        (), float(levels), device=x.device)
    s = torch.clamp(s, min=1e-8)
    xi = torch.clamp(torch.round(x / s), -levels - 1, levels)
    return xi.to(torch.int32), s


def _td_attention_impl(pol: TDPolicy, causal: bool, q, k, v, sigma_l,
                       tdcq_l, kv_len, q_offset, seed: int) -> torch.Tensor:
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    lanes = b * hq
    qh = q.to(torch.float32).transpose(1, 2)            # (B, Hq, Sq, D)
    kh = k.to(torch.float32).transpose(1, 2)            # (B, Hkv, Skv, D)
    vh = v.to(torch.float32).transpose(1, 2)
    lane_idx = torch.arange(lanes, dtype=torch.int64, device=q.device)

    # QK^T on the engine: x = q codes (Sq, D), w = k^T codes (D, Skv)
    q_int, s_q = _quant_dyn(qh, pol.bits_a, (2, 3))
    k_int, s_k = _quant_dyn(kh, pol.bits_w, (2, 3))
    kt_rep = k_int.transpose(2, 3).repeat_interleave(g, dim=1)
    sc_int = td_ops.td_vmm_lanes(
        q_int.reshape(lanes, sq, d), kt_rep.reshape(lanes, d, skv), pol,
        sigma_l, tdcq_l, td_ref.hash32(lane_idx ^ seed))
    s_k_rep = s_k.repeat_interleave(g, dim=1)           # (B, Hq, 1, 1)
    scores = sc_int.reshape(b, hq, sq, skv) * s_q * s_k_rep * (d ** -0.5)

    # the digital f32 masked softmax
    p = masked_softmax(scores, attn_mask(kv_len, q_offset, sq, skv,
                                         causal)[:, None])
    del scores, sc_int

    # PV on the engine: x = probability codes (Sq, Skv), w = v codes
    p_int, s_p = _quant_dyn(p, pol.bits_a, (2, 3))
    v_int, s_v = _quant_dyn(vh, pol.bits_w, (2, 3))
    v_rep = v_int.repeat_interleave(g, dim=1)           # (B, Hq, Skv, D)
    o_int = td_ops.td_vmm_lanes(
        p_int.reshape(lanes, sq, skv), v_rep.reshape(lanes, skv, d), pol,
        sigma_l, tdcq_l, td_ref.hash32(lane_idx ^ seed ^ _PV_SALT))
    s_v_rep = s_v.repeat_interleave(g, dim=1)
    o = o_int.reshape(b, hq, sq, d) * s_p * s_v_rep
    return o.transpose(1, 2).to(q.dtype)                # (B, Sq, Hq, D)


_lane_params_memo: dict[tuple, tuple[torch.Tensor, torch.Tensor]] = {}


def _lane_params(pols: tuple, b: int, device) -> tuple[torch.Tensor,
                                                       torch.Tensor]:
    """(sigma, tdc_q) of lane bi * Hq + h, head h's, as (B * Hq,) float32
    on ``device``: made once per (head policies, B, device), so a call
    copies nothing from the host.  Callers must not write to them."""
    key = (pols, b, torch.device(device))
    if key not in _lane_params_memo:
        _lane_params_memo[key] = tuple(torch.tensor(
            [float(getattr(p, f)) for p in pols] * b, dtype=torch.float32,
            device=device) for f in ("sigma_chain", "tdc_q"))
    return _lane_params_memo[key]


class _TDAttentionSTE(torch.autograd.Function):
    """Engine forward, clean-attention backward (the reference's
    ``_td_attention_ste``)."""

    @staticmethod
    def forward(ctx, q, k, v, pol, causal, sigma_l, tdcq_l, kv_len,
                q_offset, seed):
        ctx.save_for_backward(q, k, v, kv_len, q_offset)
        ctx.causal = causal
        return _td_attention_impl(pol, causal, q, k, v, sigma_l, tdcq_l,
                                  kv_len, q_offset, seed)

    @staticmethod
    def backward(ctx, g):
        q, k, v, kv_len, q_offset = ctx.saved_tensors
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_() for t in (q, k, v)]
            o = _masked_attn(*leaves, kv_len, q_offset, ctx.causal)
            grads = torch.autograd.grad(o, leaves, g.to(q.dtype))
        return (*grads, None, None, None, None, None, None, None)


def td_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, pols,
                 key=None, *, causal: bool = True,
                 kv_len: torch.Tensor | None = None,
                 q_offset=None) -> torch.Tensor:
    """TD-simulated attention under per-head policies.

    q (B, Sq, Hq, D); k/v (B, Skv, Hkv, D) -> (B, Sq, Hq, D).  ``pols`` is
    one TDPolicy for every head or a sequence of Hq, all sharing (mode,
    bits_a, bits_w, n_chain).  ``key`` is a raw two-word PRNG key (None:
    ``(0, 0)``, the reference's ``PRNGKey(0)``); ``kv_len`` (B,) int32
    valid KV prefix (default all of Skv); ``q_offset`` the absolute
    position of query row 0, an int or a one-element int tensor (default
    0)."""
    b, sq, hq, d = q.shape
    skv = k.shape[1]
    dev = q.device
    if isinstance(pols, TDPolicy):
        pols = (pols,) * hq
    pols = tuple(pols)
    if len(pols) != hq:
        raise ValueError(f"{len(pols)} head policies for {hq} query heads")
    p0 = pols[0]
    if p0.mode not in ("quant", "td"):
        raise ValueError(f"td_attention needs mode 'quant'|'td', "
                         f"got {p0.mode!r}")
    for p in pols[1:]:
        if (p.mode, p.bits_a, p.bits_w, p.n_chain) != \
                (p0.mode, p0.bits_a, p0.bits_w, p0.n_chain):
            raise ValueError("attention head policies must share "
                             "(mode, bits_a, bits_w, n_chain)")
    if kv_len is None:
        kv_len = torch.full((b,), skv, dtype=torch.int32, device=dev)
    if not isinstance(q_offset, torch.Tensor):
        q_offset = torch.full((1,), 0 if q_offset is None else int(q_offset),
                              dtype=torch.int32, device=dev)
    sigma_l, tdcq_l = _lane_params(pols, b, dev)
    seed = td_ref.derive_seed((0, 0) if key is None else key)
    return _TDAttentionSTE.apply(q, k, v, p0, causal, sigma_l, tdcq_l,
                                 kv_len.to(torch.int32),
                                 q_offset.to(torch.int32).reshape(1), seed)
