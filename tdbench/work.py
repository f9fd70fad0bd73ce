"""The benchmark's yardstick of work: the operations and the least bytes
that the window's traffic needed, and the H100's published peaks.

Frozen here, apart from the program, so that a later change to the port
(another code format, a fused kernel, padding rows) cannot change what a
share of a peak or of a roofline is measured against.  Nothing here reads
the port's counters; every count comes from the shapes of the model and
from the calls the benchmark itself made (real prompt rows, occupied
decode rows).

Rules:
  * td_vmm: 2 M K N bits_a operations at the int8 peak.  Its least bytes
    are the activation codes at bits_a bits, the weight codes at bits_w
    bits and the output once in the compute dtype (bf16).
  * A prefill counts the real prompt rows, not the padded bucket; its
    lm_head counts one row (the next-token logits).  A decode step counts
    its occupied rows.
  * The MoE's experts count tokens x top_k routed rows, and each expert's
    weights once per call; its router is a bf16 product.
  * Attention (flash_attn, decode_gqa) is bf16 q, K, V and output, each
    moved once, 4 D flops for each (query, key) pair a causal mask keeps,
    at the bf16 peak.
"""
from __future__ import annotations

import dataclasses

# NVIDIA H100 SXM data sheet, dense rates, at the 700 W power limit
PEAK_INT8_OPS = 1979e12
PEAK_BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12
ACT_BYTES = 2                     # bf16 compute dtype


@dataclasses.dataclass
class Work:
    """Work of a set of calls, by kernel family: operations, least bytes
    and the least time each call's roofline allows (summed per call)."""
    td_ops: float = 0.0
    td_bytes: float = 0.0
    td_min_s: float = 0.0
    flash_flops: float = 0.0
    flash_bytes: float = 0.0
    flash_min_s: float = 0.0
    decode_flops: float = 0.0
    decode_bytes: float = 0.0
    decode_min_s: float = 0.0
    router_flops: float = 0.0

    def add(self, other: "Work") -> None:
        for f in dataclasses.fields(self):
            setattr(self, f.name, getattr(self, f.name)
                    + getattr(other, f.name))

    def peak_seconds(self) -> float:
        """Seconds the work takes with each unit at its peak: the
        numerator of a model FLOP utilisation."""
        return (self.td_ops / PEAK_INT8_OPS
                + (self.flash_flops + self.decode_flops + self.router_flops)
                / PEAK_BF16_FLOPS)


def td_call(m: int, k: int, n: int, bits_a: int, bits_w: int,
            lanes_weights: int = 1) -> tuple[float, float, float]:
    """(operations, least bytes, least seconds) of one td_vmm product of m
    rows: x (m, k) codes against ``lanes_weights`` (k, n) weight matrices
    read once each."""
    ops = 2.0 * m * k * n * bits_a
    nbytes = (m * k * bits_a / 8.0 + lanes_weights * k * n * bits_w / 8.0
              + m * n * ACT_BYTES)
    return ops, nbytes, max(ops / PEAK_INT8_OPS, nbytes / HBM_BYTES_PER_S)


def _attn(pairs: float, q_rows: int, kv_rows: int, mc: dict
          ) -> tuple[float, float, float]:
    hq, hkv, hd = mc["n_heads"], mc["n_kv_heads"], mc["head_dim"]
    flops = 4.0 * hd * hq * pairs
    nbytes = ACT_BYTES * hd * (2.0 * q_rows * hq + 2.0 * kv_rows * hkv)
    return flops, nbytes, max(flops / PEAK_BF16_FLOPS,
                              nbytes / HBM_BYTES_PER_S)


def _denses(mc: dict, rows: int, lm_rows: int, w: Work) -> None:
    """Every td product of ``rows`` tokens through all layers, and
    lm_head over ``lm_rows`` of them, into ``w``."""
    d, hd = mc["d_model"], mc["head_dim"]
    hq, hkv = mc["n_heads"], mc["n_kv_heads"]
    ba, bw = mc["bits_a"], mc["bits_w"]
    shapes = [(d, hq * hd), (d, hkv * hd), (d, hkv * hd), (hq * hd, d)]
    moe = mc.get("moe")
    per_layer = []
    if moe is None:
        f = mc["d_ff"]
        shapes += [(d, f), (d, f), (f, d)]
    else:
        e, top, f = moe["num_experts"], moe["top_k"], moe["d_ff_expert"]
        per_layer = [(rows * top, d, f, e), (rows * top, d, f, e),
                     (rows * top, f, d, e)]
        w.router_flops += mc["n_layers"] * 2.0 * rows * d * e
    calls = [(rows, k, n, 1) for k, n in shapes] + per_layer
    for m, k, n, lanes in calls:
        ops, nb, t = td_call(m, k, n, ba, bw, lanes)
        w.td_ops += mc["n_layers"] * ops
        w.td_bytes += mc["n_layers"] * nb
        w.td_min_s += mc["n_layers"] * t
    ops, nb, t = td_call(lm_rows, d, mc["vocab"], ba, bw)
    w.td_ops += ops
    w.td_bytes += nb
    w.td_min_s += t


def prefill_work(mc: dict, prompt_len: int) -> Work:
    """One admission of a ``prompt_len``-token prompt (real rows only)."""
    w = Work()
    _denses(mc, prompt_len, 1, w)
    pairs = prompt_len * (prompt_len + 1) / 2.0
    fl, nb, t = _attn(pairs, prompt_len, prompt_len, mc)
    w.flash_flops += mc["n_layers"] * fl
    w.flash_bytes += mc["n_layers"] * nb
    w.flash_min_s += mc["n_layers"] * t
    return w


def decode_work(mc: dict, kv_lens: list[int]) -> Work:
    """One decode step of the occupied rows, row i attending to
    ``kv_lens[i]`` keys (its new one included)."""
    w = Work()
    rows = len(kv_lens)
    _denses(mc, rows, rows, w)
    fl, nb, t = _attn(float(sum(kv_lens)), rows, sum(kv_lens), mc)
    w.decode_flops += mc["n_layers"] * fl
    w.decode_bytes += mc["n_layers"] * nb
    w.decode_min_s += mc["n_layers"] * t
    return w
