"""Attention: GQA with qk-norm, QKV bias, RoPE and a KV cache (port of
`repro/models/attention.py`, self-attention).

Every call routes to one engine, as in the reference: with per-head
policies (``attn_pols``) to `tdsim.td_attention.td_attention` (QK^T and
PV as td_vmm lanes, over the whole cache); otherwise single-row causal
decode (s == 1 with a cache) to `kernels.decode_gqa.ops.decode_attention`,
everything else to `kernels.flash_attn.ops.flash_attention`.  The valid-KV
prefix and the causal offset ride in as device tensors.

Caches are ``{"k": (B, S_cache, Hkv, Dh), "v": ..., "idx": ...}``.  The
fill index is a host int, or with ``per_row_idx`` a (B,) int32 tensor on
the cache's device: the continuous-batching engine's ragged slots, each
decoding against its own valid prefix.  The per-row index never leaves the
device (no host sync inside a step).  The reference's
``dynamic_update_slice`` returns a new cache; the port writes the new keys
and values into the cache tensors in place (a cache is never read again at
its old fill level) and returns the same tensors with the advanced index.
The per-row cache takes no TD attention (the reference's ValueError).

Cross-attention (``kv_from``, the encoder's output): K and V come from
``kv_from``, neither q nor k gets RoPE, no cache is read or written, the
valid-KV prefix is all of ``kv_from`` or the row sums of
``kv_from_valid``, and masking is never causal.  It always runs on
flash_attn, at a single query row too (decode_gqa is only the single-row
causal self-attention path).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelCfg
from repro_torch.kernels.decode_gqa.ops import decode_attention
from repro_torch.kernels.flash_attn.ops import flash_attention
from repro_torch.models import common
from repro_torch.tdsim.td_attention import td_attention


def attn_init(gen: torch.Generator, cfg: ModelCfg, pol, dtype=torch.float32,
              device=None, cross: bool = False) -> dict:
    """The four denses (and, with qk-norm, the q and k norms: never in a
    cross-attention block), drawn from ``gen`` in the reference's order."""
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
    if cfg.qk_norm and not cross:
        p["q_norm"] = common.rmsnorm_init(hd, dtype, device)
        p["k_norm"] = common.rmsnorm_init(hd, dtype, device)
    return p


def attention(params: dict, x: torch.Tensor, cfg: ModelCfg, pol,
              positions: torch.Tensor, cache: dict | None = None,
              kv_from: torch.Tensor | None = None,
              kv_from_valid: torch.Tensor | None = None,
              causal: bool = True, key=None, attn_pols=None,
              dense=None) -> tuple[torch.Tensor, dict | None]:
    """Self-attention with an optional KV cache, or cross-attention on
    ``kv_from`` (B, Skv, d) (``kv_from_valid``: a (B, Skv) or (Skv,)
    valid-prefix mask of it); x (B, S, d).  ``key`` seeds the four denses'
    noise (``fold_key(key, 0..3)``) and TD attention's (``fold_key(key,
    4)``).  ``dense(p, h, j)`` computes the j-th dense (wq, wk, wv, wo:
    0..3); None means ``common.dense(p, h, pol, fold_key(key, j))``."""
    is_cross = kv_from is not None
    if is_cross:
        cache = None                    # the reference reads none either
    if attn_pols is not None and cache is not None \
            and isinstance(cache["idx"], torch.Tensor):
        raise ValueError("TD-quantized attention takes a scalar "
                         "q_offset; per-slot ragged caches run the "
                         "precise flash-decode path")
    b, s, _ = x.shape
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    dev = x.device
    if dense is None:
        def dense(p, h, j):
            return common.dense(p, h, pol, common.fold_key(key, j))

    src = kv_from if is_cross else x
    skv = src.shape[1]
    q = dense(params["wq"], x, 0).reshape(b, s, hq, hd)
    k = dense(params["wk"], src, 1).reshape(b, skv, hkv, hd)
    v = dense(params["wv"], src, 2).reshape(b, skv, hkv, hd)
    if cfg.qk_norm and "q_norm" in params:
        q = common.rmsnorm(params["q_norm"], q, cfg.rms_eps)
        k = common.rmsnorm(params["k_norm"], k, cfg.rms_eps)

    per_row = cache is not None and isinstance(cache["idx"], torch.Tensor)
    if per_row and s != 1:
        raise ValueError("per-slot (vector-idx) caches support single-token "
                         f"decode steps only, got s={s}")
    if not is_cross:
        q = common.apply_rope(q, positions, cfg.rope_theta)
        if cache is None:
            k_pos = positions
        elif per_row:
            # each slot's KV lands at its own fill position (unclamped, as
            # in the reference: a free slot's index keeps growing)
            k_pos = cache["idx"][:, None]
        else:
            k_pos = cache["idx"] + torch.arange(s, device=dev)
        k = common.apply_rope(k, k_pos, cfg.rope_theta)

    new_cache = None
    if per_row:
        idx = cache["idx"]
        s_cache = cache["k"].shape[1]
        # the reference's per-row dynamic_update_slice clamps each start
        # into [0, S - 1]: a free slot past S rewrites its last position
        rows = torch.arange(b, device=dev)
        at = idx.clamp(0, s_cache - 1)
        cache["k"][rows, at] = k[:, 0].to(cache["k"].dtype)
        cache["v"][rows, at] = v[:, 0].to(cache["v"].dtype)
        new_cache = {"k": cache["k"], "v": cache["v"], "idx": idx + 1}
        kv_len = torch.clamp(idx + 1, max=s_cache)
        k_use, v_use = cache["k"], cache["v"]
    elif cache is not None:
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
        if kv_from_valid is None:
            kv_len = torch.full((b,), skv, dtype=torch.int32, device=dev)
        elif kv_from_valid.dim() == 2:
            kv_len = kv_from_valid.to(torch.int32).sum(-1, dtype=torch.int32)
        else:
            kv_len = kv_from_valid.to(torch.int32).sum(
                dtype=torch.int32).expand(b).contiguous()
        pos_q = positions if positions.dim() == 1 else positions[0]
        q_offset = pos_q[:1].to(torch.int32)

    causal = causal and not is_cross
    if attn_pols is not None:
        o = td_attention(q, k_use, v_use, attn_pols,
                         common.fold_key(key, 4), causal=causal,
                         kv_len=kv_len, q_offset=q_offset)
    elif s == 1 and cache is not None and causal:
        # single-row causal decode: the query is the last valid position,
        # so prefix masking is causality
        o = decode_attention(q[:, 0].contiguous(), k_use, v_use,
                             kv_len)[:, None]
    else:
        o = flash_attention(q.contiguous(), k_use.contiguous(),
                            v_use.contiguous(), kv_len, q_offset,
                            causal=causal)
    y = dense(params["wo"], o.reshape(b, s, hq * hd), 3)
    return y, new_cache


def init_cache(b: int, s_cache: int, cfg: ModelCfg, dtype=torch.bfloat16,
               device=None, per_row_idx: bool = False) -> dict:
    """KV cache with a scalar fill index, or with ``per_row_idx`` one (B,)
    int32 fill index on ``device`` for every batch row (the serving
    engine's ragged slots)."""
    shape = (b, s_cache, cfg.n_kv_heads, cfg.hd)
    idx = (torch.zeros((b,), dtype=torch.int32, device=device)
           if per_row_idx else 0)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "idx": idx}
