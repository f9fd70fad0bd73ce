"""Entry point of the decode attention engine (port of
`repro/kernels/decode_gqa/ops.py`).

On DTensors the kernel runs on local shards of the batch or of the query
and KV heads (`kernels.sharded`); a cache split over its sequence is
gathered first.  Under a `roofline.counter.Counter` a call records the
reference's analytic cost (4 B Skv Hq D FLOPs; q, o and the cache read
or written once) and does not run."""
from __future__ import annotations

import torch

from repro_torch.kernels import sharded
from repro_torch.kernels.decode_gqa.decode_gqa import decode_gqa
from repro_torch.roofline import counter

# batch rows, or query and KV heads: (q, k, v, length) -> o
_OPTIONS = [((0, 0, 0, 0), (0,)), ((1, 2, 2, None), (1,))]


def _decode(q, k, v, length):
    c = counter.active()
    if c is None:
        return decode_gqa(q, k, v, length)
    b, hq, d = q.shape
    s, hkv = k.shape[1], k.shape[2]
    c.record_kernel("decode_gqa", flops=4.0 * b * s * hq * d,
                    nbytes=k.element_size() * b * (2.0 * hq * d
                                                   + 2.0 * s * hkv * d))
    return torch.empty_like(q)


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     length: torch.Tensor) -> torch.Tensor:
    """q (B, Hq, D); k/v (B, S, Hkv, D); length (B,) int32 -> (B, Hq, D)."""
    args = [q, k, v, length.to(torch.int32)]
    if sharded.mesh_of(q, k, v) is not None:
        return sharded.local_call(_decode, args, _OPTIONS)
    return _decode(*args)
