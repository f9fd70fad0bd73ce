"""Attention: GQA with qk-norm, QKV bias, RoPE and a KV cache (port of
`repro/models/attention.py`, self-attention with a scalar cache index).

Every call routes to one of the fused engines, as in the reference:
single-row causal decode (s == 1 with a cache) to
`kernels.decode_gqa.ops.decode_attention`, everything else to
`kernels.flash_attn.ops.flash_attention`.  The valid-KV prefix and the
causal offset ride into the kernels as device tensors.

Caches are ``{"k": (B, S_cache, Hkv, Dh), "v": ..., "idx": int}``.  The
reference's ``dynamic_update_slice`` returns a new cache; the port writes
the new keys and values into the cache tensors in place (a cache is never
read again at its old fill level) and returns the same tensors with the
advanced index.  The per-row ragged cache of the continuous-batching
engine, cross-attention and TD attention are not ported yet.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelCfg
from repro_torch.kernels.decode_gqa.ops import decode_attention
from repro_torch.kernels.flash_attn.ops import flash_attention
from repro_torch.models import common


def attn_init(gen: torch.Generator, cfg: ModelCfg, pol, dtype=torch.float32,
              device=None) -> dict:
    d, hq, hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    p = {
        "wq": common.dense_init(gen, d, hq * hd, pol, cfg.qkv_bias, dtype,
                                device=device),
        "wk": common.dense_init(gen, d, hkv * hd, pol, cfg.qkv_bias, dtype,
                                device=device),
        "wv": common.dense_init(gen, d, hkv * hd, pol, cfg.qkv_bias, dtype,
                                device=device),
        "wo": common.dense_init(gen, hq * hd, d, pol, False, dtype,
                                scale=1.0 / (hq * hd) ** 0.5, device=device),
    }
    if cfg.qk_norm:
        p["q_norm"] = common.rmsnorm_init(hd, dtype, device)
        p["k_norm"] = common.rmsnorm_init(hd, dtype, device)
    return p


def attention(params: dict, x: torch.Tensor, cfg: ModelCfg, pol,
              positions: torch.Tensor, cache: dict | None = None,
              causal: bool = True, key=None,
              attn_pols=None) -> tuple[torch.Tensor, dict | None]:
    """Self-attention with an optional KV cache; x (B, S, d).  ``key``
    seeds the four denses' noise (``fold_key(key, 0..3)``)."""
    if attn_pols is not None:
        raise NotImplementedError("TD attention (td_attention) is not yet "
                                  "ported (ROADMAP.md §1, step 9)")
    b, s, _ = x.shape
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    dev = x.device
    kq, kk, kv_, ko = (common.fold_key(key, i) for i in range(4))

    q = common.dense(params["wq"], x, pol, kq).reshape(b, s, hq, hd)
    k = common.dense(params["wk"], x, pol, kk).reshape(b, s, hkv, hd)
    v = common.dense(params["wv"], x, pol, kv_).reshape(b, s, hkv, hd)
    if cfg.qk_norm and "q_norm" in params:
        q = common.rmsnorm(params["q_norm"], q, cfg.rms_eps)
        k = common.rmsnorm(params["k_norm"], k, cfg.rms_eps)

    q = common.apply_rope(q, positions, cfg.rope_theta)
    if cache is None:
        k_pos = positions
    else:
        k_pos = cache["idx"] + torch.arange(s, device=dev)
    k = common.apply_rope(k, k_pos, cfg.rope_theta)

    new_cache = None
    if cache is not None:
        idx = int(cache["idx"])
        s_cache = cache["k"].shape[1]
        # dynamic_update_slice clamps the start so the update fits
        start = min(max(idx, 0), s_cache - s)
        cache["k"][:, start:start + s] = k.to(cache["k"].dtype)
        cache["v"][:, start:start + s] = v.to(cache["v"].dtype)
        new_cache = {"k": cache["k"], "v": cache["v"], "idx": idx + s}
        kv_len = torch.full((b,), idx + s, dtype=torch.int32, device=dev)
        q_offset = torch.full((1,), idx, dtype=torch.int32, device=dev)
        k_use, v_use = cache["k"], cache["v"]
    else:
        k_use, v_use = k, v
        kv_len = torch.full((b,), s, dtype=torch.int32, device=dev)
        pos_q = positions if positions.dim() == 1 else positions[0]
        q_offset = pos_q[:1].to(torch.int32)

    if s == 1 and cache is not None and causal:
        # single-row causal decode: the query is the last valid position,
        # so prefix masking is causality
        o = decode_attention(q[:, 0].contiguous(), k_use, v_use,
                             kv_len)[:, None]
    else:
        o = flash_attention(q.contiguous(), k_use.contiguous(),
                            v_use.contiguous(), kv_len, q_offset,
                            causal=causal)
    y = common.dense(params["wo"], o.reshape(b, s, hq * hd), pol, ko)
    return y, new_cache


def init_cache(b: int, s_cache: int, cfg: ModelCfg, dtype=torch.bfloat16,
               device=None) -> dict:
    """KV cache with a scalar fill index."""
    shape = (b, s_cache, cfg.n_kv_heads, cfg.hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "idx": 0}
