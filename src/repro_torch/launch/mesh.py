"""Device meshes of the port (port of `repro/launch/mesh.py`).

A mesh is a `torch.distributed.device_mesh.DeviceMesh` with named
dimensions, made over the default process group, which the caller brings
up first at the mesh's size (NCCL on cards, gloo on CPU processes, the
``fake`` backend for the dry run's abstract production meshes).

Production mesh: 256 cards as (data 32, model 8), or 512 as (pod 2, data
32, model 8).  The reference lays a TPU pod out as 16 x 16; on H100s the
``model`` axis (tensor parallelism, the per-layer all-gathers and
reduce-scatters) is kept inside one 8-card host, whose cards are joined
all to all by NVLink, and ``data`` (FSDP and the gradient sums) crosses
hosts over InfiniBand.  A 16-wide model axis would put every tensor-
parallel collective on the inter-host links.  The pod axis composes with
data for pure data parallelism across pods.

The sharding rules (`launch.sharding`) and `models.common.maybe_constrain`
read a mesh through `axis_names` and `axis_size`, so they take a
`DeviceMesh` or any object with ``axis_names`` and a ``shape`` mapping
(the reference's tests' fake mesh), and the same stand-in can be handed
to both packages.  `activate_mesh` makes a mesh the ambient one that
`models.common._abstract_mesh` returns.

Importing this module touches no device and no process group.
"""
from __future__ import annotations

import contextlib
import math

from repro_torch import device as device_mod

PRODUCTION_SHAPE = (32, 8)
PRODUCTION_AXES = ("data", "model")
MULTI_POD_SHAPE = (2, 32, 8)
MULTI_POD_AXES = ("pod", "data", "model")

_ACTIVE: list = []


def make_mesh(shape: tuple, axes: tuple, device=None):
    """A `DeviceMesh` of ``shape`` with dimension names ``axes`` over the
    default process group, whose world size must be the product of
    ``shape``.  ``device``: the cards (None, CUDA) or ``"cpu"``."""
    from torch.distributed.device_mesh import init_device_mesh
    dev = device_mod.resolve(device)
    return init_device_mesh(dev.type, tuple(shape),
                            mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False, device=None):
    """The production mesh: (data 32, model 8), or (pod 2, data 32, model
    8) with ``multi_pod`` (the module docstring says why model is 8)."""
    if multi_pod:
        return make_mesh(MULTI_POD_SHAPE, MULTI_POD_AXES, device)
    return make_mesh(PRODUCTION_SHAPE, PRODUCTION_AXES, device)


@contextlib.contextmanager
def activate_mesh(mesh):
    """Make ``mesh`` the ambient mesh (`active_mesh`) inside the block."""
    _ACTIVE.append(mesh)
    try:
        yield mesh
    finally:
        _ACTIVE.pop()


def active_mesh():
    """The innermost `activate_mesh` mesh, or None."""
    return _ACTIVE[-1] if _ACTIVE else None


def axis_names(mesh) -> tuple:
    """Dimension names of a `DeviceMesh` or of a duck-typed mesh."""
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names if names is not None else mesh.axis_names)


def axis_size(mesh, name: str) -> int:
    """Size of mesh dimension ``name``."""
    shape = mesh.shape
    if isinstance(shape, dict):
        return int(shape[name])
    return int(shape[axis_names(mesh).index(name)])


def mesh_size(mesh) -> int:
    return math.prod(axis_size(mesh, a) for a in axis_names(mesh))


def dp_axes(mesh) -> tuple:
    """Axes that shard the batch (pod folds into data-parallel)."""
    return ("pod", "data") if "pod" in axis_names(mesh) else ("data",)


def dp_size(mesh) -> int:
    return math.prod(axis_size(mesh, a) for a in dp_axes(mesh))


def tp_size(mesh) -> int:
    return axis_size(mesh, "model")
