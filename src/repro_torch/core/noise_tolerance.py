"""Noise-tolerance back-annotation (port of `repro/core/noise_tolerance.py`,
paper Fig. 10).

The paper injects Gaussian noise into the convolution outputs of LSQ-4bit
ResNet20/CIFAR10, measures the relative accuracy drop 1 - Acc(sigma)/Acc(0)
and defines sigma_array_max as the noise level where the drop crosses 1 %.
That sigma feeds the design space (Fig. 11) through
`tdsim.policy.solve_network_policies`.

Two entry tiers, as in the reference:

  * `find_sigma_max`          -- one ``eval_fn(sigma, key)`` call per
                                 (sigma, repeat), a python loop;
  * `find_sigma_max_batched`  -- the whole (layers x sigma grid x repeats
                                 [+ clean]) product through a batched
                                 eval, ``chunk_size`` probes a call.

The batched eval contract stands in for the reference's ``jax.vmap``:
``eval_fn(sigma_vecs, keys) -> (P,) accuracies`` with ``sigma_vecs`` a
(P, n_layers) float32 tensor on the sweep's device and ``keys`` a list of
P raw PRNG keys (`repro_torch.prng`).  A model runs the P probes as lanes
(`models.resnet.forward_lanes`, one td_vmm launch a site).  There is no
jit, so the reference's ``_JIT_CACHE`` of compiled probe runners has no
counterpart: nothing is traced or compiled per eval.

Both tiers share `crossing_sigma` and the key scheme: batched layer l draws
``split(fold_in(key, l), S*R + 1)``, eval (i, r) takes keys[i*R + r] and
the clean eval keys[-1], so a scalar run of layer l with key
``fold_in(key, l)`` sees the same (sigma, key) pairs.

`write_policies` writes a search's per-layer policies in the reference
bench's JSON shape, which ``--td-per-layer @file`` reads back.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Callable, Sequence

import numpy as np
import torch

from repro_torch import device as device_mod
from repro_torch import prng


@dataclasses.dataclass(frozen=True)
class NoiseToleranceResult:
    sigmas: np.ndarray          # grid of injected sigma (output-LSB units)
    rel_drop: np.ndarray        # 1 - acc(sigma)/acc(0)
    acc_clean: float
    sigma_max: float            # interpolated 1 %-drop crossing (Fig. 10b)


@dataclasses.dataclass(frozen=True)
class BatchedNoiseToleranceResult:
    """Per-layer Fig. 10 sweep of one batched search."""
    sigmas: np.ndarray          # (S,) shared sigma grid
    rel_drop: np.ndarray        # (L, S) per-layer relative drop curves
    acc_clean: np.ndarray       # (L,) clean accuracy per layer probe
    sigma_max: np.ndarray       # (L,) interpolated 1 %-crossings
    n_evals: int                # probes evaluated

    def layer(self, l: int) -> NoiseToleranceResult:
        """Scalar-result view of one layer."""
        return NoiseToleranceResult(self.sigmas, self.rel_drop[l],
                                    float(self.acc_clean[l]),
                                    float(self.sigma_max[l]))


def crossing_sigma(sigmas: np.ndarray, rel_drop: np.ndarray,
                   rel_drop_max: float = 0.01) -> np.ndarray:
    """Vectorized first crossing of the drop threshold with linear
    interpolation; `rel_drop` is (..., S) over the shared (S,) sigma grid.
    No crossing gives the last grid point, a crossing at index 0 the
    first."""
    sig = np.asarray(sigmas, np.float64)
    drop = np.asarray(rel_drop, np.float64)
    above = drop > rel_drop_max                       # (..., S)
    any_above = above.any(axis=-1)
    j = np.argmax(above, axis=-1)                     # first True (0 if none)
    # the interpolated value is only selected when 1 <= j <= S-1, so
    # clamping covers the endpoint branches (and S == 1)
    jm = np.minimum(np.maximum(j, 1), len(sig) - 1)
    d0 = np.take_along_axis(drop, (jm - 1)[..., None], axis=-1)[..., 0]
    d1 = np.take_along_axis(drop, jm[..., None], axis=-1)[..., 0]
    t = (rel_drop_max - d0) / np.maximum(d1 - d0, 1e-12)
    interp = sig[jm - 1] + t * (sig[jm] - sig[jm - 1])
    out = np.where(j == 0, sig[0], interp)
    return np.where(any_above, out, sig[-1])


def find_sigma_max(eval_fn: Callable[[float, tuple], float],
                   sigmas: Sequence[float], key: tuple[int, int],
                   rel_drop_max: float = 0.01,
                   n_repeats: int = 3) -> NoiseToleranceResult:
    """Sweep the sigma grid, average repeated noisy evals, interpolate the
    crossing of the relative-accuracy-drop threshold (paper: 1 %)."""
    keys = prng.split(key, len(sigmas) * n_repeats + 1)
    acc_clean = float(eval_fn(0.0, keys[-1]))
    accs = []
    for i, s in enumerate(sigmas):
        vals = [float(eval_fn(float(s), keys[i * n_repeats + r]))
                for r in range(n_repeats)]
        accs.append(float(np.mean(vals)))
    accs = np.asarray(accs)
    drop = 1.0 - accs / max(acc_clean, 1e-9)
    sig = np.asarray(list(sigmas), dtype=np.float64)
    sigma_max = float(crossing_sigma(sig, drop, rel_drop_max))
    return NoiseToleranceResult(sig, drop, acc_clean, sigma_max)


def probe_vectors(sigmas: Sequence[float], n_layers: int,
                  n_repeats: int) -> np.ndarray:
    """(L, S*R + 1, L) per-layer sigma vectors: row (i*R + r) of layer l is
    sigmas[i] * e_l, the last row is the all-zero clean probe."""
    sig = np.asarray(list(sigmas), np.float64)
    s, l, r = len(sig), int(n_layers), int(n_repeats)
    vecs = np.zeros((l, s * r + 1, l), np.float64)
    for li in range(l):
        vecs[li, : s * r, li] = np.repeat(sig, r)
    return vecs


def _eval_sharded(eval_fn, v: torch.Tensor, k: list, mesh) -> torch.Tensor:
    """``eval_fn(v, k)`` with the probe axis placed over the mesh's data
    axes (`launch.sharding.shard_probes`): each rank evaluates its block
    and the accuracies are all-gathered in probe order.  A probe count
    that does not divide runs whole on every rank."""
    from torch.distributed.tensor import DTensor
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import sharding
    if mesh_lib.dp_size(mesh) == 1:
        return torch.as_tensor(eval_fn(v, k)).reshape(-1)
    (vd,) = sharding.shard_probes(mesh, (v,))
    lo, hi = sharding.local_block(
        v.shape[0], mesh, sharding.probe_spec(mesh, v.shape[0], 1)[0])
    acc = torch.as_tensor(eval_fn(vd.to_local(), k[lo:hi])).reshape(-1)
    return DTensor.from_local(acc, mesh, vd.placements,
                              run_check=False).full_tensor()


def _run_probes(eval_fn, flat_v: torch.Tensor, flat_k: list,
                chunk_size: int | None, mesh=None) -> np.ndarray:
    """Evaluate all (probe, key) pairs: one call, or ``chunk_size`` probes
    a call with the tail chunk padded by repeats of the first probe (their
    results discarded), so every call has the same P.

    With ``mesh`` the probe axis (the within-chunk axis when chunked) is
    split over the mesh's data axes (`_eval_sharded`): each probe is an
    independent eval, so the sweep runs data-parallel across devices with
    one all-gather of accuracies a call, and every probe's result is the
    one the unsharded call gives it."""
    t = flat_v.shape[0]

    def run(v, k):
        if mesh is None:
            return eval_fn(v, k)
        return _eval_sharded(eval_fn, v, k, mesh)

    if chunk_size is None or chunk_size >= t:
        accs = [run(flat_v, flat_k)]
    else:
        if chunk_size < 1:
            raise ValueError(f"chunk_size must be >= 1, got {chunk_size}")
        pad = (-t) % chunk_size
        flat_v = torch.cat([flat_v, flat_v[:1].expand(pad, -1)])
        flat_k = flat_k + [flat_k[0]] * pad
        accs = [run(flat_v[c:c + chunk_size], flat_k[c:c + chunk_size])
                for c in range(0, t + pad, chunk_size)]
    accs = torch.cat([torch.as_tensor(a).reshape(-1) for a in accs])
    return accs.cpu().numpy().astype(np.float64)[:t]


def find_sigma_max_batched(eval_fn: Callable[[torch.Tensor, list],
                                             torch.Tensor],
                           sigmas: Sequence[float],
                           key: tuple[int, int],
                           n_layers: int,
                           rel_drop_max: float = 0.01,
                           n_repeats: int = 3,
                           chunk_size: int | None = None,
                           mesh=None,
                           device=None) -> BatchedNoiseToleranceResult:
    """Per-layer sigma_array_max for all layers through the batched eval
    (see the module docstring for its contract), the probe vectors made
    on ``device`` (None: CUDA).

    The sweep probes one layer at a time (one-hot sigma vectors) over the
    full (layers x sigma grid x repeats [+ clean]) product.  Layer l draws
    ``split(fold_in(key, l), S*R + 1)``: eval (i, r) uses keys[i*R + r]
    and the clean eval keys[-1], as a scalar `find_sigma_max` of layer l
    with key ``fold_in(key, l)`` does.  ``chunk_size`` bounds the probes
    of one call; the results equal the unchunked call's.  ``mesh`` (a
    `DeviceMesh` with a 'data' axis, every rank calling with the same
    arguments) splits each call's probes over the data axes
    (`_run_probes`); the results equal the unsharded call's bit for bit.
    """
    dev = device_mod.resolve(device)
    sig = np.asarray(list(sigmas), np.float64)
    s, l, r = len(sig), int(n_layers), int(n_repeats)
    per = s * r + 1
    vecs = probe_vectors(sig, l, r)                       # (L, per, L)
    flat_k = [k for li in range(l)
              for k in prng.split(prng.fold_in(key, li), per)]
    flat_v = torch.tensor(vecs.reshape(l * per, l), dtype=torch.float32,
                          device=dev)
    accs = _run_probes(eval_fn, flat_v, flat_k, chunk_size,
                       mesh).reshape(l, per)
    acc_clean = accs[:, -1]
    acc = accs[:, : s * r].reshape(l, s, r).mean(axis=-1)
    drop = 1.0 - acc / np.maximum(acc_clean[:, None], 1e-9)
    sigma_max = crossing_sigma(sig, drop, rel_drop_max)
    return BatchedNoiseToleranceResult(sig, drop, acc_clean, sigma_max,
                                       n_evals=l * per)


def write_policies(path, model: str, sites: Sequence[str],
                   sigma_max: Sequence[float], net) -> None:
    """The per-layer policy artifact of the reference bench
    (``per_layer_policies_<model>.json`` of
    `benchmarks/bench_noise_tolerance.write_artifacts`): one record a site
    with its sigma_max and the solved policy of ``net`` (a
    `tdsim.policy.NetworkPolicy`), at ``path``."""
    doc = {"model": model, "layers": [
        {"site": site, "sigma_max": float(sig),
         "bits_a": pol.bits_a, "bits_w": pol.bits_w,
         "n_chain": pol.n_chain, "redundancy": pol.redundancy,
         "tdc_q": pol.tdc_q, "sigma_chain": pol.sigma_chain}
        for site, sig, pol in zip(sites, sigma_max, net.layers)]}
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(doc, f, indent=1)
