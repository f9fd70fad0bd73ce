"""The kernels' entry points on DTensors: each kernel runs on local shards.

The CUDA kernels are ctypes launches on raw device pointers, so they take
neither DTensors nor fake tensors.  `local_call` redistributes an entry
point's DTensor operands to a layout the kernel computes shard by shard
(for attention: batch rows, or query and KV heads together; for a
noiseless td_vmm: rows of x, or columns of w), calls the entry point on
the local tensors and wraps its result as a DTensor.  A mesh dimension on
which the operands agree on no such layout, or whose split does not
divide, is replicated first (the redistribution is an all-gather, which
the dry run's counter records), so no kernel ever computes on a shard it
was not meant for.  A plain tensor among the operands (a fill index made
inside the step) counts as replicated and is cut to its shard.
"""
from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard


def mesh_of(*tensors):
    """The device mesh of the first DTensor among ``tensors``, or None."""
    for t in tensors:
        if isinstance(t, DTensor):
            return t.device_mesh
    return None


def _choose(mesh, tensors, options):
    """Per mesh dimension, the first option (a tensor dim a tensor, None
    for replicated) that every DTensor operand already realizes."""
    chosen = []
    for i in range(mesh.ndim):
        pick = None
        for opt, outd in options:
            ok = True
            for t, d in zip(tensors, opt):
                if not isinstance(t, DTensor):
                    continue
                p = t.placements[i]
                if d is None:
                    ok = ok and p.is_replicate()
                else:
                    ok = ok and p.is_shard(d)
            if ok and any(d is not None for d in opt):
                pick = (opt, outd)
                break
        chosen.append(pick)
    # drop the mesh dimensions whose split does not divide a tensor dim
    for t_i, t in enumerate(tensors):
        if t is None:
            continue
        ways: dict[int, int] = {}
        for i, c in enumerate(chosen):
            if c is not None and c[0][t_i] is not None:
                ways[c[0][t_i]] = ways.get(c[0][t_i], 1) * mesh.size(i)
        bad = {d for d, n in ways.items() if t.shape[d] % n}
        if bad:
            chosen = [None if c is not None and c[0][t_i] in bad else c
                      for c in chosen]
    return chosen


def _placements(chosen, j, k=0):
    """Placements of operand j (k=0) or output j (k=1) under ``chosen``."""
    return [Shard(c[k][j]) if c is not None and c[k][j] is not None
            else Replicate() for c in chosen]


def _local(t, mesh, pl):
    if t is None or not isinstance(t, torch.Tensor):
        return t
    if not isinstance(t, DTensor):
        if all(p.is_replicate() for p in pl):
            return t
        t = DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                               run_check=False)
    return t.redistribute(mesh, pl).to_local()


def local_call(fn, tensors: list, options: list):
    """``fn(*locals)`` on the local shards of ``tensors`` (DTensors, plain
    tensors or None), laid out on each mesh dimension by the first of
    ``options`` that the operands realize, replicated where none does.
    An option is a pair: the dim of each operand split over the mesh
    dimension (None: replicated), and the dim of each of fn's outputs
    that then comes out split.  Returns the outputs as DTensors."""
    mesh = mesh_of(*tensors)
    chosen = _choose(mesh, tensors, options)
    locals_ = [_local(t, mesh, _placements(chosen, j))
               for j, t in enumerate(tensors)]
    out = fn(*locals_)
    outs = out if isinstance(out, tuple) else (out,)
    wrapped = tuple(DTensor.from_local(o, mesh, _placements(chosen, j, 1),
                                       run_check=False)
                    for j, o in enumerate(outs))
    return wrapped if isinstance(out, tuple) else wrapped[0]


def gather_dp(w: torch.Tensor) -> torch.Tensor:
    """A weight gathered over the data-parallel axes ('pod', 'data') it is
    split over (FSDP: the full weight is rebuilt for its use; the
    backward of the gather is the gradient's reduce-scatter); a plain
    tensor, or one split over 'model' alone, as it is."""
    if not isinstance(w, DTensor):
        return w
    names = w.device_mesh.mesh_dim_names or ()
    pl = [Replicate() if n in ("pod", "data") and p.is_shard() else p
          for n, p in zip(names, w.placements)]
    if pl == list(w.placements):
        return w
    return w.redistribute(w.device_mesh, pl)


__all__ = ["mesh_of", "local_call", "gather_dp"]
