"""Declarative sharding rules (port of `repro/launch/sharding.py`):
parameter-path regex -> spec, and specs -> DTensor placements.

2D strategy (MaxText-style): the contraction/model-width dim of every large
matrix is sharded over 'data' (FSDP storage sharding) and the parallel dim
over 'model' (tensor parallelism).  Experts shard over 'model' (EP).
Vectors/norms/scalars replicate.

A spec is a plain tuple with one entry per tensor dimension: None, an
axis name, or a tuple of axis names (the dimension split over several
mesh axes, major to minor), equal element for element to the reference's
`PartitionSpec`; ``()`` replicates.  All rules are validated against
divisibility at spec-construction time; a dim that does not divide its
mesh axes falls back to replication on that dim (correct, just less
sharded), so every (arch x mesh) cell runs by construction.

`placements` turns a spec into one `Shard(d)` / `Replicate()` a mesh
dimension, the counterpart of a `NamedSharding`; `distribute` places a
parameter tree as DTensors.  A dimension split over several mesh axes
must name them in mesh order: DTensor then splits it over the first
mesh dimension, then each piece over the next, which is the reference's
major-to-minor order (`_placements` raises on another order).
"""
from __future__ import annotations

import contextlib
import re

import torch
from torch.distributed.tensor import (DTensor, Replicate, Shard,
                                      distribute_tensor)
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.launch.mesh import axis_names, axis_size, dp_axes


# (regex on "/"-joined path, spec template)
# DP = FSDP/storage axis, TP = tensor axis; templates use the strings and
# are resolved per-mesh.
_RULES: list[tuple[str, tuple]] = [
    # embeddings / heads
    (r"embed/table$",                       ("TP", "DP")),
    (r"lm_head/w$",                         ("DP", "TP")),
    (r"adapter/w$",                         (None, "TP")),
    # attention (order matters: chanmix/timemix wv|wk|wr before attn generic)
    (r"chanmix/wk/w$",                      ("DP", "TP")),
    (r"chanmix/wv/w$",                      ("TP", "DP")),
    (r"chanmix/wr/w$",                      ("DP", "TP")),
    (r"timemix/w[rkvg]/w$",                 ("DP", "TP")),
    (r"timemix/wo/w$",                      ("TP", "DP")),
    (r"(attn|xattn|shared_attn)/w[qkv]/w$", ("DP", "TP")),
    (r"(attn|xattn|shared_attn)/w[qkv]/b$", ("TP",)),
    (r"(attn|xattn|shared_attn)/wo/w$",     ("TP", "DP")),
    # dense mlp
    (r"mlp/w[ig]/w$",                       ("DP", "TP")),
    (r"mlp/wo/w$",                          ("TP", "DP")),
    # MoE: experts over TP (EP), contraction over DP
    (r"moe/w[ig]$",                         ("TP", "DP", None)),
    (r"moe/wo$",                            ("TP", None, "DP")),
    (r"moe/router/w$",                      (None, None)),
    # mamba2
    (r"mamba/in_proj/w$",                   ("DP", None)),
    (r"mamba/out_proj/w$",                  ("TP", "DP")),
]


def _dp(mesh) -> tuple:
    """(dp axes, their product, the spec entry that names them)."""
    dp = dp_axes(mesh)
    n = 1
    for a in dp:
        n *= axis_size(mesh, a)
    return dp, n, (dp if len(dp) > 1 else dp[0])


def map_with_path(fn, tree, prefix: str = ""):
    """``fn(path, leaf)`` over a nested dict/list tree, paths "/"-joined
    as the reference's (dict keys, list indices); None stays None.  A
    tuple is a leaf: it is a spec."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, f"{prefix}{k}/")
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [map_with_path(fn, v, f"{prefix}{i}/")
                for i, v in enumerate(tree)]
    if tree is None:
        return None
    return fn(prefix[:-1], tree)


def _resolve(template: tuple, shape: tuple, mesh) -> tuple:
    """Template -> spec with divisibility fallback.  Right-aligned:
    stacked (scan-over-layers) params carry an extra leading layer dim that
    stays unsharded."""
    _, dp_n, dp_part = _dp(mesh)
    tp_n = axis_size(mesh, "model")
    extra = len(shape) - len(template)
    parts = [None] * extra
    for dim, t in zip(shape[extra:], template):
        if t == "DP" and dim % dp_n == 0:
            parts.append(dp_part)
        elif t == "TP" and dim % tp_n == 0:
            parts.append("model")
        else:
            parts.append(None)
    return tuple(parts)


def param_specs(params, mesh, serving: bool = False):
    """Tree of specs matching ``params`` (tensors or anything with
    ``ndim`` and ``shape``).

    serving=True drops the FSDP ('data') storage sharding so weights are
    not re-all-gathered every decode step: inference has no optimizer
    state, so the capacity pressure that motivates FSDP is gone and the
    per-step gather traffic dominates instead.
    """
    def spec_of(path, leaf):
        for rx, template in _RULES:
            if re.search(rx, path):
                if leaf.ndim not in (len(template), len(template) + 1):
                    return ()
                t = tuple(None if (serving and x == "DP") else x
                          for x in template)
                return _resolve(t, tuple(leaf.shape), mesh)
        return ()          # replicate (norms, scalars, small vectors)

    return map_with_path(spec_of, params)


def batch_spec(mesh, batch_size: int, rank: int) -> tuple:
    """Shard the leading batch dim over (pod, data) when divisible."""
    _, dp_n, dp_part = _dp(mesh)
    lead = dp_part if batch_size % dp_n == 0 else None
    return (lead, *([None] * (rank - 1)))


def probe_spec(mesh, n_probes: int, rank: int, axis: int = 0) -> tuple:
    """Shard probe axis ``axis`` of a rank-``rank`` eval batch over (pod,
    data).

    The noise-tolerance sweep's flat probe axis (or, when chunked, the
    within-chunk axis) is embarrassingly parallel (each probe is an
    independent model eval), so it rides the data axis like any batch dim.
    Falls back to replication when the axis does not divide (correct, just
    unsharded), keeping every (probe-count x mesh) combination runnable.
    """
    _, dp_n, dp_part = _dp(mesh)
    parts: list = [None] * rank
    if n_probes % dp_n == 0:
        parts[axis] = dp_part
    return tuple(parts)


def cache_specs(state_shapes, mesh):
    """Specs of a decode-state tree (KV caches, SSM states).

    KV caches (B, S, H, D): batch over DP when divisible, else the sequence
    dim takes DP (flash-decode style split-K); heads over TP when divisible.
    SSM/wkv states (B, H, ...): heads over TP.
    """
    dp, dp_n, dp_part = _dp(mesh)
    tp_n = axis_size(mesh, "model")

    def spec_of(path, leaf):
        if not hasattr(leaf, "shape") or leaf.ndim == 0 \
                or path.endswith("idx"):
            return ()
        shape = tuple(leaf.shape)
        if re.search(r"(^|/)(k|v)$", path) and leaf.ndim in (4, 5):
            lead = (None,) if leaf.ndim == 5 else ()   # stacked layer dim
            b, s, h, _ = shape[-4:]
            # heads over TP when they divide; otherwise split-K: sequence
            # over TP (flash-decode style)
            b_ax = dp_part if b % dp_n == 0 else None
            seq_axes: list = []
            seq_div = 1
            if b_ax is None and s % dp_n == 0:
                seq_axes += list(dp)
                seq_div *= dp_n
            h_ax = "model" if h % tp_n == 0 else None
            if h_ax is None and s % (seq_div * tp_n) == 0:
                seq_axes.append("model")
            s_ax = (None if not seq_axes
                    else seq_axes[0] if len(seq_axes) == 1
                    else tuple(seq_axes))
            return (*lead, b_ax, s_ax, h_ax, None)
        if re.search(r"(ssm|wkv)$", path):
            lead = (None,) if leaf.ndim in (5,) else ()
            b, h = shape[-4], shape[-3]
            return (*lead, dp_part if b % dp_n == 0 else None,
                    "model" if h % tp_n == 0 else None)
        if re.search(r"conv$", path) and leaf.ndim in (3, 4):
            lead = (None,) if leaf.ndim == 4 else ()
            b, _, c = shape[-3:]
            return (*lead, dp_part if b % dp_n == 0 else None, None,
                    "model" if c % tp_n == 0 else None)
        if re.search(r"enc_out$", path) and leaf.ndim == 3:
            b, _, d = shape
            return (dp_part if b % dp_n == 0 else None, None,
                    "model" if d % tp_n == 0 else None)
        if leaf.ndim >= 1 and shape[0] % dp_n == 0:
            return (dp_part, *([None] * (leaf.ndim - 1)))
        return ()

    return map_with_path(spec_of, state_shapes)


def placements(spec: tuple, mesh) -> list:
    """The DTensor placements of ``spec`` on ``mesh``: for each mesh
    dimension, `Shard(d)` where tensor dim d names it, else `Replicate()`.
    A dim naming several axes must name them in mesh order (the module
    docstring says why)."""
    names = axis_names(mesh)
    out: list = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec {spec}: dim {d} names {axes} out of the "
                             f"mesh's order {names}")
        for i in idx:
            out[i] = Shard(d)
    return out


def distribute(tree, specs, mesh):
    """Place every tensor of ``tree`` as a DTensor by its spec in
    ``specs`` (a tree of the same structure); other leaves pass.  Each rank cuts its own
    shard out of the full tensor it holds (no scatter from rank 0: the
    trees are made from one seed on every rank)."""
    flat = {}
    map_with_path(lambda p, s: flat.__setitem__(p, s), specs)
    return map_with_path(
        lambda p, t: distribute_tensor(t, mesh, placements(flat[p], mesh),
                                       src_data_rank=None)
        if isinstance(t, torch.Tensor) else t, tree)


def shard_probes(mesh, arrays, axis: int = 0):
    """Place each tensor's probe axis over the mesh data axis
    (`probe_spec`); ``arrays`` is a tuple of same-probe-count tensors."""
    return tuple(distribute_tensor(
        a, mesh, placements(probe_spec(mesh, a.shape[axis], a.ndim, axis),
                            mesh), src_data_rank=None) for a in arrays)


def _no_strategy(e: Exception) -> bool:
    """Whether DTensor refused an op for want of a sharding strategy (it
    raises before it computes anything)."""
    msg = str(e)
    return ("sharding strategy" in msg or "Sharding propagation failed"
            in msg)


class ReplicateFallback(TorchDispatchMode):
    """Runs an op that DTensor cannot shard on replicated operands.

    DTensor has no sharding strategy for some ops on the models' paths
    (the MoE's stable sort and slot scatter, ``searchsorted``, indexing a
    dim that is sharded, a write into a slice of a sharded KV cache) and
    refuses layouts it cannot propagate.  Inside this mode such an op's
    DTensor operands are redistributed to `Replicate()` (an all-gather,
    or an all-reduce of a partial sum, which a `roofline.counter.Counter`
    entered outside it records), the op runs on the full local tensors
    and its outputs come back replicated; an in-place op writes the
    result back into its DTensor's own shard.  No op computes on a shard
    it was not meant for.  A view that a local shard's strides refuse
    (a shard that gloo's re-sharding left non-contiguous) runs again,
    sharded, on contiguous copies of the shards.  Every other op goes to
    DTensor untouched."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if not any(issubclass(t, DTensor) for t in types):
            return func(*args, **kwargs)
        if func._schema.is_mutable and args \
                and not isinstance(args[0], DTensor):
            # a write into a plain (replicated) tensor from DTensors
            return _replicated(func, args, kwargs)
        try:
            return func(*args, **kwargs)
        except (NotImplementedError, RuntimeError) as e:
            if _view_refused(e):
                c_args, c_kwargs = _contiguous_locals((args, kwargs))
                return func(*c_args, **c_kwargs)
            if not _no_strategy(e):
                raise
        return _replicated(func, args, kwargs)


def _view_refused(e: Exception) -> bool:
    """Whether a view of a DTensor failed on its local shard's strides (a
    shard that a redistribution left non-contiguous: gloo, which has no
    all-to-all, re-shards by an all-gather and a chunk)."""
    return "view size is not compatible" in str(e)


def _contiguous_locals(tree):
    """``tree`` with each DTensor's local shard made contiguous, its
    global shape, stride and placements kept (the op then still runs
    sharded, as `reshape` would run it)."""
    from torch.utils._pytree import tree_map
    return tree_map(lambda a: DTensor.from_local(
        a.to_local().contiguous(), a.device_mesh, a.placements,
        run_check=False, shape=a.shape, stride=a.stride())
        if isinstance(a, DTensor) else a, tree)


def _replicated(func, args, kwargs):
    from torch.utils._pytree import tree_leaves, tree_map
    from torch._guards import detect_fake_mode
    dts = [a for a in tree_leaves((args, kwargs)) if isinstance(a, DTensor)]
    mesh = dts[0].device_mesh
    rep = [Replicate()] * mesh.ndim
    fake = detect_fake_mode() is not None

    def full(a):
        if not isinstance(a, DTensor):
            return a
        if fake and any(type(p).__name__ == "_StridedShard"
                        for p in a.placements):
            return _gathered_fake(a)
        return a.redistribute(mesh, rep).to_local()

    l_args, l_kwargs = tree_map(full, (args, kwargs))
    out = func(*l_args, **l_kwargs)
    if func._schema.is_mutable:
        dst = args[0]
        if not isinstance(dst, DTensor):
            return out
        # the op wrote into its first (DTensor) argument's full copy: cut
        # this rank's shard out of it and write that back
        new = DTensor.from_local(l_args[0], mesh, rep, run_check=False)
        dst.to_local().copy_(new.redistribute(mesh, dst.placements)
                             .to_local())
        return dst
    return tree_map(lambda o: DTensor.from_local(o, mesh, rep,
                                                 run_check=False)
                    if isinstance(o, torch.Tensor) else o, out)


def _gathered_fake(a):
    """The whole of a fake DTensor laid out by strided shards (a reshape's
    layout, whose redistribution DTensor computes from data that fake
    tensors do not hold): the collectives that gather it, issued on its
    local shard so that a counter sees them, and an uninitialized tensor
    of its global shape (a fake tensor has no values to gather)."""
    from torch.distributed import _functional_collectives as funcol
    mesh, loc = a.device_mesh, a.to_local()
    for i, p in enumerate(a.placements):
        if p.is_shard() or type(p).__name__ == "_StridedShard":
            loc = funcol.all_gather_tensor(loc, 0, (mesh, i))
        elif p.is_partial():
            loc = funcol.all_reduce(loc, "sum", (mesh, i))
    return loc.new_empty(a.shape)


@contextlib.contextmanager
def sharded_region(mesh):
    """Run model code on DTensors over ``mesh``: the mesh is the ambient
    one (`maybe_constrain`), plain tensors made inside (a mask, a fill
    index) act as replicated (`implicit_replication`), and ops DTensor
    cannot shard run replicated (`ReplicateFallback`)."""
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.launch.mesh import activate_mesh
    with activate_mesh(mesh), implicit_replication(), ReplicateFallback():
        yield mesh


def local_block(n: int, mesh, spec_entry) -> tuple[int, int]:
    """[start, stop) of this rank's block of a length-``n`` axis sharded
    over ``spec_entry`` (an axis name, a tuple of them, or None), major to
    minor in the spec's order, as `placements` lays it out."""
    if spec_entry is None:
        return 0, n
    axes = (spec_entry,) if isinstance(spec_entry, str) else spec_entry
    idx, ways = 0, 1
    for a in axes:
        size = axis_size(mesh, a)
        idx = idx * size + mesh.get_local_rank(a)
        ways *= size
    step = n // ways
    return idx * step, (idx + 1) * step


__all__ = ["param_specs", "batch_spec", "probe_spec", "cache_specs",
           "placements", "distribute", "shard_probes",
           "local_block", "map_with_path", "ReplicateFallback",
           "sharded_region"]
