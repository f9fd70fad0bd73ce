"""Entry points of the TD engine (port of `repro/kernels/td_vmm/ops.py`).

``td_vmm_seeded`` flattens leading batch dims and runs the kernel wrapper
with the policy's (sigma_chain, tdc_q) and the seed as device tensors.  The
contraction is not padded: the kernel masks positions past K itself.  A
solved policy's (sigma, q) operand is made once per (device, sigma, q) and
reused; a runtime policy's (`models.common.runtime_td_policy`: sigma and q
are 0-d views of one row of an operand tensor) passes that row itself, so
an in-place write to the operand tensor moves the next launch's operating
point, and no memo entry, copy or host read is made.  The seed operand is
filled on the device from the host integer (a fill kernel takes the value
as an argument), so a call copies nothing from the host and never waits
for the device, however many seeds a run derives.

``td_vmm_lanes`` is the reference's ``jax.vmap`` over ``td_vmm_seeded``
(the batched noise search's probes, TD attention's ``_lane_vmm``): P lanes
of x, one w shared or one a lane, and a (sigma, tdc_q, seed) a lane as
device tensors, in one launch.

On DTensors a noiseless call runs on local shards of x's rows or w's
columns (`kernels.sharded`): each output element then depends on its row
and column alone.  The noise hashes an element's position within the
call, so a noisy call, and every lane call, runs on replicated operands.
Under a `roofline.counter.Counter` a call records 2 M K N bits_a int8
operations and its bytes (codes in, f32 out) and does not run.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import sharded
from repro_torch.kernels.td_vmm import ref as td_ref
from repro_torch.kernels.td_vmm.td_vmm import td_vmm as td_vmm_kernel
from repro_torch.roofline import counter

_params: dict[tuple, torch.Tensor] = {}


def runtime_operands(sigma: float, tdc_q: float, device) -> torch.Tensor:
    """The memoized params f32 [sigma, q] of a solved policy on
    ``device``.  The first call of a policy copies them to the card from
    pinned memory, without waiting for the device (a plain copy from the
    host would be a host sync inside the step that makes it)."""
    device = torch.device(device)
    key = (device, float(sigma), float(tdc_q))
    if key not in _params:
        t = torch.tensor([float(sigma), float(tdc_q)], dtype=torch.float32)
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        _params[key] = t.to(device)
    return _params[key]


def policy_params(pol, device) -> torch.Tensor:
    """The (2,) f32 [sigma, q] operand of ``pol`` on ``device``: the row
    that a runtime policy's sigma and q view (never copied), or the
    memoized tensor of a solved policy's floats.  Tensor operands that are
    not the two adjacent elements of one f32 row on ``device`` raise: a
    copy here would run at every launch."""
    sigma, q = pol.sigma_chain, pol.tdc_q
    if not isinstance(sigma, torch.Tensor) and \
            not isinstance(q, torch.Tensor):
        return runtime_operands(sigma, q, device)
    if not (isinstance(sigma, torch.Tensor) and isinstance(q, torch.Tensor)
            and sigma.dtype == q.dtype == torch.float32
            and sigma.device == q.device == torch.device(device)
            and sigma.dim() == q.dim() == 0
            and sigma.untyped_storage().data_ptr()
            == q.untyped_storage().data_ptr()
            and q.storage_offset() == sigma.storage_offset() + 1):
        raise ValueError(
            "a td policy's tensor (sigma_chain, tdc_q) must be the 0-d "
            "views of one f32 row on the launch's device "
            "(models.common.runtime_td_policy)")
    return sigma.as_strided((2,), (1,), sigma.storage_offset())


def _record(x_int, w_int, pol, lanes: int = 1) -> torch.Tensor:
    """Count one call under the active counter; an empty result."""
    k, n = w_int.shape[-2:]
    m = x_int.numel() // k
    counter.active().record_kernel(
        "td_vmm", int_ops=2.0 * m * k * n * pol.bits_a,
        nbytes=float(m * k + w_int.numel() + 4 * m * n))
    return x_int.new_empty((*x_int.shape[:-1], n), dtype=torch.float32)


def _noiseless(pol) -> bool:
    sigma = pol.sigma_chain
    return not isinstance(sigma, torch.Tensor) and float(sigma) == 0.0


def td_vmm_seeded(x_int: torch.Tensor, w_int: torch.Tensor, pol,
                  seed: int) -> torch.Tensor:
    """x_int (..., K) and w_int (K, N) signed codes; ``seed`` an already
    derived uint32 noise seed (`ref.derive_seed`).  Returns (..., N) f32."""
    if sharded.mesh_of(x_int, w_int) is not None:
        last = x_int.dim() - 1
        options = ([((0, None), (0,)), ((None, 1), (last,))]
                   if _noiseless(pol) else [])
        return sharded.local_call(
            lambda x, w: td_vmm_seeded(x, w, pol, seed), [x_int, w_int],
            options)
    if counter.active() is not None:
        return _record(x_int, w_int, pol)
    k, n = w_int.shape
    lead = x_int.shape[:-1]
    params = policy_params(pol, x_int.device)
    seed_t = torch.full((1,), int(seed), dtype=torch.int64,
                        device=x_int.device)
    out = td_vmm_kernel(x_int.reshape(-1, k), w_int, params, seed_t,
                        bits_a=pol.bits_a, bits_w=pol.bits_w,
                        n_chain=pol.n_chain, k_true=k)
    return out.reshape(*lead, n)


def td_vmm(x_int: torch.Tensor, w_int: torch.Tensor, pol,
           key=(0, 0)) -> torch.Tensor:
    """Key-taking wrapper: derives the seed from both words of a raw
    uint32 PRNG key (``(0, 0)`` is the reference's ``PRNGKey(0)``)."""
    return td_vmm_seeded(x_int, w_int, pol, td_ref.derive_seed(key))


def td_vmm_lanes(x_int: torch.Tensor, w_int: torch.Tensor, pol,
                 sigma: torch.Tensor, tdc_q: torch.Tensor,
                 seeds: torch.Tensor) -> torch.Tensor:
    """x_int (P, ..., K) signed codes, w_int (K, N) shared, (P, K, N), or
    (L, K, N) with L dividing P (lane p reads w_int[p % L]);
    ``sigma`` and ``tdc_q`` (P,) float tensors and ``seeds`` (P,) int64
    (derived uint32 seeds) on x's device; ``pol`` gives the widths and
    n_chain.  Returns (P, ..., N) f32: lane p is ``td_vmm_seeded`` of lane
    p's operands at its sigma, tdc_q and seed."""
    if sharded.mesh_of(x_int, w_int, sigma, tdc_q, seeds) is not None:
        return sharded.local_call(
            lambda *a: td_vmm_lanes(a[0], a[1], pol, *a[2:]),
            [x_int, w_int, sigma, tdc_q, seeds], [])
    if counter.active() is not None:
        return _record(x_int, w_int, pol)
    p_lanes = x_int.shape[0]
    k, n = w_int.shape[-2:]
    lead = x_int.shape[1:-1]
    params = torch.stack([sigma.to(torch.float32),
                          tdc_q.to(torch.float32)], dim=-1)
    out = td_vmm_kernel(x_int.reshape(p_lanes, -1, k), w_int, params,
                        seeds.to(torch.int64), bits_a=pol.bits_a,
                        bits_w=pol.bits_w, n_chain=pol.n_chain, k_true=k)
    return out.reshape(p_lanes, *lead, n)
