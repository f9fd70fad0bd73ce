"""Entry points of the TD engine (port of `repro/kernels/td_vmm/ops.py`).

``td_vmm_seeded`` flattens leading batch dims and runs the kernel wrapper
with the policy's (sigma_chain, tdc_q) and the seed as device tensors.  The
contraction is not padded: the kernel masks positions past K itself.  The
(sigma, q) operand is made once per (device, sigma, q) and reused; the seed
operand is filled on the device from the host integer (a fill kernel takes
the value as an argument), so a call copies nothing from the host and
never waits for the device, however many seeds a run derives.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.td_vmm import ref as td_ref
from repro_torch.kernels.td_vmm.td_vmm import td_vmm as td_vmm_kernel

_params: dict[tuple, torch.Tensor] = {}


def runtime_operands(sigma: float, tdc_q: float, seed: int,
                     device) -> tuple[torch.Tensor, torch.Tensor]:
    """(params f32 [sigma, q] (memoized), seed int64 (1,)) on ``device``."""
    key = (torch.device(device), float(sigma), float(tdc_q))
    if key not in _params:
        _params[key] = torch.tensor([float(sigma), float(tdc_q)],
                                    dtype=torch.float32, device=device)
    return _params[key], torch.full((1,), int(seed), dtype=torch.int64,
                                    device=device)


def td_vmm_seeded(x_int: torch.Tensor, w_int: torch.Tensor, pol,
                  seed: int) -> torch.Tensor:
    """x_int (..., K) and w_int (K, N) signed codes; ``seed`` an already
    derived uint32 noise seed (`ref.derive_seed`).  Returns (..., N) f32."""
    k, n = w_int.shape
    lead = x_int.shape[:-1]
    params, seed_t = runtime_operands(pol.sigma_chain, pol.tdc_q, seed,
                                      x_int.device)
    out = td_vmm_kernel(x_int.reshape(-1, k), w_int, params, seed_t,
                        bits_a=pol.bits_a, bits_w=pol.bits_w,
                        n_chain=pol.n_chain, k_true=k)
    return out.reshape(*lead, n)


def td_vmm(x_int: torch.Tensor, w_int: torch.Tensor, pol,
           key=(0, 0)) -> torch.Tensor:
    """Key-taking wrapper: derives the seed from both words of a raw
    uint32 PRNG key (``(0, 0)`` is the reference's ``PRNGKey(0)``)."""
    return td_vmm_seeded(x_int, w_int, pol, td_ref.derive_seed(key))
