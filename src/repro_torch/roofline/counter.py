"""Per-device FLOP, byte, collective and memory counter of one step (the
port's counterpart of `repro/roofline/hlo_parse.py`, which reads the same
quantities out of a compiled program's HLO text).

`Counter` is a `TorchDispatchMode`.  Entered under `FakeTensorMode`, with
the parameters as DTensors over a mesh of the ``fake`` process group, it
sees every op the step runs.  An op on DTensors is handed on to DTensor
(the mode returns NotImplemented), which lowers it to ops on the local
shards and the `_c10d_functional` collectives of any redistribution, and
those come back through the mode: everything it counts is per device.

* FLOPs: `torch.utils.flop_counter`'s formulas (matmuls, convolutions,
  attention) on the local shapes.
* Bytes: every local op that is not a view reads its tensor inputs once
  and writes its outputs once.  This is an unfused count: XLA's ``bytes
  accessed`` is taken after fusion, which keeps elementwise chains in
  registers, so this count is pessimistic against it.  `op_bytes` holds the
  result bytes by op (`op_bytes_breakdown`).
* Collectives: each all-gather, reduce-scatter, all-reduce, all-to-all or
  permute goes into a `CollectiveStats` with the reference's ring link
  model (`hlo_parse.py:98-130`): all-gather out (n-1)/n, reduce-scatter
  in (n-1)/n, all-reduce 2 size (n-1)/n, all-to-all size (n-1)/n, permute
  size, n the group's size, and the link bytes split by the mesh axis the
  group spans.
* Memory: the bytes of the local tensors alive, from each op's new
  outputs until they are freed, and their peak (`peak_bytes`); what was
  allocated before the mode was entered (parameters, optimizer state) is
  the caller's to add.

The port's CUDA kernels are opaque calls, as the reference's Pallas calls
are to XLA: under an active counter each kernel entry point records its
analytic work (`record_kernel`) and returns an empty result of its shape
instead of running its plain version.  A loop that would dispatch one op
set per token (`models.rwkv6.wkv6_scan`) runs one iteration under
`repeat`, which counts it, and its backward, trip-count times.
"""
from __future__ import annotations

import dataclasses
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

COLL_KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
              "collective-permute")

# _c10d_functional op name -> (kind, index of the group-name argument)
_FUNCOL = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "all_reduce": "all-reduce",
    "all_reduce_": "all-reduce",
    "all_to_all_single": "all-to-all",
    "broadcast": "collective-permute",
}

_ACTIVE: list = []


def active():
    """The innermost entered `Counter`, or None."""
    return _ACTIVE[-1] if _ACTIVE else None


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


@dataclasses.dataclass
class CollectiveStats:
    counts: dict
    operand_bytes: dict
    link_bytes: dict
    link_bytes_by_axis: dict = dataclasses.field(default_factory=dict)

    @classmethod
    def empty(cls) -> "CollectiveStats":
        return cls({k: 0 for k in COLL_KINDS},
                   {k: 0.0 for k in COLL_KINDS},
                   {k: 0.0 for k in COLL_KINDS}, {})

    def add(self, kind: str, operand_bytes: float, result_bytes: float,
            n: int, axis: str | None = None, times: float = 1.0) -> None:
        """One collective of ``kind`` over a group of ``n`` ranks (``axis``
        the mesh axis, or axes joined by "+", it spans)."""
        frac = (n - 1) / n
        if kind == "all-gather":
            link = result_bytes * frac
        elif kind == "reduce-scatter":
            link = operand_bytes * frac
        elif kind == "all-reduce":
            link = 2.0 * operand_bytes * frac
        elif kind == "all-to-all":
            link = operand_bytes * frac
        else:
            link = operand_bytes
        self.counts[kind] += times
        self.operand_bytes[kind] += operand_bytes * times
        self.link_bytes[kind] += link * times
        if axis is not None:
            self.link_bytes_by_axis[axis] = \
                self.link_bytes_by_axis.get(axis, 0.0) + link * times

    @property
    def total_operand_bytes(self) -> float:
        return sum(self.operand_bytes.values())

    @property
    def total_link_bytes(self) -> float:
        return sum(self.link_bytes.values())


class Counter(TorchDispatchMode):
    """See the module docstring.  ``mesh``: the `DeviceMesh` whose process
    groups the collectives run over (None: collectives are counted with
    no axis)."""

    def __init__(self, mesh=None):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self._flop_registry = flop_registry
        self.flops = 0.0
        self.bytes = 0.0
        self.op_bytes: dict[str, float] = {}
        self.op_flops: dict[str, float] = {}
        self.collectives = CollectiveStats.empty()
        self.kernels: dict[str, dict] = {}
        self.live_bytes = 0
        self.peak_bytes = 0
        self.scans: dict[str, int] = {}
        self._mult = 1.0
        self._hidden = 0
        self._groups: dict[str, tuple[str, int]] = {}
        if mesh is not None:
            names = mesh.mesh_dim_names
            for i, name in enumerate(names):
                g = mesh.get_group(i)
                self._groups[g.group_name] = (name, mesh.size(i))

    # -- bookkeeping --------------------------------------------------------
    def __enter__(self):
        _ACTIVE.append(self)
        self._unhook = _hide_meta_propagation(self)
        return super().__enter__()

    def __exit__(self, *exc):
        _ACTIVE.remove(self)
        self._unhook()
        return super().__exit__(*exc)

    def scaled(self, n: float):
        """Context: everything counted inside is counted ``n`` times."""
        counter = self

        class _Scale:
            def __enter__(self):
                self.prev = counter._mult
                counter._mult = self.prev * n

            def __exit__(self, *exc):
                counter._mult = self.prev
        return _Scale()

    def record_kernel(self, name: str, *, flops: float = 0.0,
                      int_ops: float = 0.0, nbytes: float = 0.0) -> None:
        """One call of a kernel: its analytic floating-point operations,
        integer operations and bytes, per device."""
        k = self.kernels.setdefault(
            name, {"calls": 0.0, "flops": 0.0, "int_ops": 0.0, "bytes": 0.0})
        m = self._mult
        k["calls"] += m
        k["flops"] += flops * m
        k["int_ops"] += int_ops * m
        k["bytes"] += nbytes * m

    def _track(self, t: torch.Tensor) -> None:
        n = _nbytes(t)
        if not n:
            return
        self.live_bytes += n
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)

        def free(counter=self, n=n):
            counter.live_bytes -= n
        weakref.finalize(t, free)

    def _collective(self, name: str, args, out) -> None:
        kind = _FUNCOL[name]
        group = next((a for a in args if isinstance(a, str)), None)
        axis, n = self._groups.get(group, (None, None))
        if n is None:
            n = next((a for a in args if isinstance(a, int)), 2)
        inp = args[0]
        ins = [inp] if isinstance(inp, torch.Tensor) else list(inp)
        outs = [o for o in tree_leaves(out) if isinstance(o, torch.Tensor)]
        self.collectives.add(kind, float(sum(_nbytes(t) for t in ins)),
                             float(sum(_nbytes(t) for t in outs)), int(n),
                             axis, self._mult)

    # -- dispatch -----------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented            # DTensor lowers it to local ops
        out = func(*args, **kwargs)
        if self._hidden:
            return out
        if not isinstance(func, torch._ops.OpOverload):
            return out
        ns = func.namespace
        name = func.__name__.split(".")[0]
        if ns == "_c10d_functional":
            if name in _FUNCOL:
                self._collective(name, args, out)
            return out
        if ns != "aten" or func.is_view or name in ("detach", "lift_fresh",
                                                     "alias"):
            return out
        if any(t.device.type == "meta" for t in tree_leaves(out)
               if isinstance(t, torch.Tensor)):
            return out                  # shapes only: no work, no memory
        m = self._mult
        packet = func.overloadpacket
        key = str(packet).split(".")[-1]
        if packet in self._flop_registry:
            f = self._flop_registry[packet](*args, **kwargs, out_val=out) * m
            self.flops += f
            self.op_flops[key] = self.op_flops.get(key, 0.0) + f
        ins = [t for t in tree_leaves((args, kwargs))
               if isinstance(t, torch.Tensor)]
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        b_out = float(sum(_nbytes(t) for t in outs))
        self.bytes += (float(sum(_nbytes(t) for t in ins)) + b_out) * m
        self.op_bytes[key] = self.op_bytes.get(key, 0.0) + b_out * m
        mutable = func._schema.is_mutable
        if not mutable:
            for t in outs:
                self._track(t)
        return out

    def op_bytes_breakdown(self, top: int = 25) -> dict:
        """Result bytes by op, the largest ``top``."""
        return dict(sorted(self.op_bytes.items(),
                           key=lambda kv: -kv[1])[:top])


def _hide_meta_propagation(c: Counter):
    """DTensor infers an op's output shape by running it once on fake
    tensors of the global shapes (`_propagate_tensor_meta_non_cached`);
    those calls pass through the mode too and must not be counted.  Hides
    them from ``c`` until the returned function is called."""
    from torch.distributed.tensor import DTensor
    prop = DTensor._op_dispatcher.sharding_propagator
    orig = prop._propagate_tensor_meta_non_cached

    def hidden(*a, **k):
        c._hidden += 1
        try:
            return orig(*a, **k)
        finally:
            c._hidden -= 1
    prop._propagate_tensor_meta_non_cached = hidden

    def unhook():
        if prop.__dict__.get("_propagate_tensor_meta_non_cached") is hidden:
            del prop._propagate_tensor_meta_non_cached
    return unhook


class _Repeat(torch.autograd.Function):
    @staticmethod
    def forward(ctx, fn, n, *inputs):
        ctx.fn, ctx.n = fn, n
        ctx.save_for_backward(*inputs)
        with active().scaled(n):
            return fn(*inputs)

    @staticmethod
    def backward(ctx, *grads):
        inputs = ctx.saved_tensors
        with torch.enable_grad(), active().scaled(ctx.n):
            leaves = [t.detach().requires_grad_(t.is_floating_point())
                      for t in inputs]
            outs = ctx.fn(*leaves)
            outs = outs if isinstance(outs, tuple) else (outs,)
            pairs = [(o, g) for o, g in zip(outs, grads)
                     if g is not None and o.requires_grad]
            wrt = [t for t in leaves if t.requires_grad]
            got = iter(torch.autograd.grad([o for o, _ in pairs],
                                           wrt, [g for _, g in pairs],
                                           allow_unused=True))
        res = []
        for t in leaves:
            g = next(got) if t.requires_grad else None
            res.append(torch.zeros_like(t) if g is None and t.requires_grad
                       else g)
        return (None, None, *res)


def repeat(name: str, n: int, fn, *inputs):
    """Under the active counter: ``fn(*inputs)`` run once and counted ``n``
    times, its backward (a recompute and its gradient) too; ``name`` and
    ``n`` go into the counter's ``scans``."""
    c = active()
    c.scans[name] = c.scans.get(name, 0) + n
    return _Repeat.apply(fn, n, *inputs)


__all__ = ["COLL_KINDS", "CollectiveStats", "Counter", "active", "repeat"]
