"""Oracles of the TD-VMM kernel (port of `repro/kernels/td_vmm/ref.py`).

The counter hash runs in int64 masked to 32 bits: torch has no uint32
right shift on the CPU, and the split multiply below keeps every product
inside int64, so `hash32` is bit-exact with the reference's uint32 hash.
"""
from __future__ import annotations

import math

import torch

GOLDEN = 0x9E3779B9
MASK32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for x in [0, 2^32), without int64 overflow."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & MASK32


def hash32(x: torch.Tensor) -> torch.Tensor:
    """Avalanching integer hash (lowbias32) on int64 values in [0, 2^32)."""
    x = x.to(torch.int64) & MASK32
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    x = x ^ (x >> 16)
    return x


def _uniform(bits: torch.Tensor) -> torch.Tensor:
    """uint32 values (held in int64) -> (0, 1) float32 from the top 24 bits."""
    return (bits >> 8).to(torch.float32) * (1.0 / (1 << 24)) \
        + (0.5 / (1 << 24))


def gauss_noise(idx: torch.Tensor, seed) -> torch.Tensor:
    """Standard normal from a linear index + seed (Box-Muller); ``seed`` is
    an int or an int64 tensor holding one uint32 value."""
    i = (idx.to(torch.int64) & MASK32) ^ (seed & MASK32)
    u1 = _uniform(hash32(i))
    u2 = _uniform(hash32(i ^ GOLDEN))
    return torch.sqrt(-2.0 * torch.log(u1)) * torch.cos(2.0 * math.pi * u2)


def _hash32_int(x: int) -> int:
    x &= MASK32
    x ^= x >> 16
    x = (x * 0x7FEB352D) & MASK32
    x ^= x >> 15
    x = (x * 0x846CA68B) & MASK32
    x ^= x >> 16
    return x


def derive_seed(key) -> int:
    """Per-call uint32 noise seed from a raw uint32 PRNG key (two words,
    e.g. ``(0, 0)`` for the reference's ``PRNGKey(0)``): mixes both words,
    ``hash32(k0 ^ GOLDEN) ^ k1``, as the reference does."""
    words = [int(v) & MASK32 for v in torch.as_tensor(key).reshape(-1)
             .tolist()]
    return _hash32_int(words[0] ^ GOLDEN) ^ words[-1]


def _seg_scale(n_seg: int, n_chain: int, k_true: int,
               device=None) -> torch.Tensor:
    """(n_seg,) noise scale sqrt(live / n_chain) of each segment."""
    live = torch.minimum(
        torch.full((n_seg,), float(n_chain), device=device),
        torch.clamp(k_true - torch.arange(n_seg, device=device) * n_chain,
                    min=1).to(torch.float32))
    return torch.sqrt(live / n_chain)


def td_vmm_ref(xu: torch.Tensor, wu: torch.Tensor, *, bits_a: int,
               n_chain: int, sigma, tdc_q, seed: int,
               k_true: int | None = None) -> torch.Tensor:
    """Bit-serial noisy VMM on offset-encoded (unsigned) operands.

    xu (M, K) codes in [0, 2^bits_a), wu (K, N); K a multiple of n_chain.
    Returns (M, N) float32: sum_seg sum_b 2^b TDCround(plane_b @ w_seg + eps).
    """
    m, k = xu.shape
    n = wu.shape[1]
    n_seg = k // n_chain
    if k_true is None:
        k_true = k
    dev = xu.device
    sigma = torch.as_tensor(sigma, dtype=torch.float32, device=dev)
    q = torch.clamp(torch.as_tensor(tdc_q, dtype=torch.float32, device=dev),
                    min=1.0)
    scale = _seg_scale(n_seg, n_chain, k_true, dev)
    w_seg = wu.reshape(n_seg, n_chain, n).to(torch.float32)
    seg_i = torch.arange(n_seg, dtype=torch.int64, device=dev)
    row_i = torch.arange(m, dtype=torch.int64, device=dev)
    col_i = torch.arange(n, dtype=torch.int64, device=dev)
    out = torch.zeros((m, n), dtype=torch.float32, device=dev)
    for b in range(bits_a):
        plane = ((xu >> b) & 1).reshape(m, n_seg, n_chain).to(torch.float32)
        partial = torch.einsum("msk,skn->msn", plane, w_seg)
        # linear noise index ((b*n_seg + seg)*M + row)*N + col, mod 2^32
        idx = (((b * n_seg + seg_i[None, :, None]) * m
                + row_i[:, None, None]) & MASK32) * n + col_i[None, None, :]
        partial = partial + (sigma * scale)[None, :, None] \
            * gauss_noise(idx, seed)
        partial = q * torch.round(partial / q)
        out = out + (2.0 ** b) * partial.sum(1)
    return out


def td_vmm_signed_ref(x_int: torch.Tensor, w_int: torch.Tensor, *,
                      bits_a: int, bits_w: int, n_chain: int, sigma, tdc_q,
                      seed: int) -> torch.Tensor:
    """Signed codes in: offset encoding, contraction padding (masked to code
    0) and the digital correction side sums around `td_vmm_ref`."""
    m, k = x_int.shape
    ox, ow = 2 ** (bits_a - 1), 2 ** (bits_w - 1)
    n_seg = max(1, -(-k // n_chain))
    k_pad = n_seg * n_chain
    xu = torch.nn.functional.pad(x_int + ox, (0, k_pad - k))
    wu = torch.nn.functional.pad(w_int + ow, (0, 0, 0, k_pad - k))
    main = td_vmm_ref(xu, wu, bits_a=bits_a, n_chain=n_chain, sigma=sigma,
                      tdc_q=tdc_q, seed=seed, k_true=k)
    corr_w = ox * wu.sum(0).to(torch.float32)
    corr_x = ow * xu.sum(-1, keepdim=True).to(torch.float32)
    return main - corr_w[None, :] - corr_x + k * ox * ow
