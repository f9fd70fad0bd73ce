"""Port parity: the sharding rules (`repro_torch.launch.sharding`) and the
abstract inputs (`repro_torch.launch.specs`) against the reference's.

* `param_specs` (serving on and off) of every arch's full config, on the
  fake meshes (16, 16), (2, 16, 16), (32, 8) and (2, 4): the reference's
  specs of its `jax.eval_shape` params, the port's of its fake-tensor
  params, element for element.
* `batch_specs` of every (arch x shape) cell on the same meshes: shapes,
  dtypes and specs (the reference's ShapeDtypeStruct maker swapped for a
  tuple maker: it needs a real jax Mesh).
* `cache_specs` of every arch's decode state at decode_32k and long_500k.
* The reference's own three cases (tests/test_distribution.py:20-76) on
  the port's functions, and the DTensor placements of a spec: a dim over
  several axes splits major to minor, as the reference's.
"""
import torch_threads  # noqa: F401  (first: torch's threads under xdist)
import functools

import jax
import pytest
import torch

import repro.configs as jcfgs
from repro.launch import sharding as jsl
from repro.launch import specs as jspecs
from repro.models import common as jcommon
from repro.models import get_api as jget_api
import repro_torch.configs as tcfgs
from repro_torch.launch import sharding as tsl
from repro_torch.launch import specs as tspecs
from repro_torch.models import common as tcommon
from repro_torch.models import get_api as tget_api


class FakeMesh:
    """The reference tests' duck-typed mesh: axis names and a shape map."""

    def __init__(self, shape: tuple, axes: tuple):
        self.axis_names = axes
        self.shape = dict(zip(axes, shape))

    def __repr__(self):
        return f"FakeMesh({self.shape})"


MESHES = [FakeMesh((16, 16), ("data", "model")),
          FakeMesh((2, 16, 16), ("pod", "data", "model")),
          FakeMesh((32, 8), ("data", "model")),
          FakeMesh((2, 4), ("data", "model"))]
MESH_IDS = ["16x16", "2x16x16", "32x8", "2x4"]


def _jpath(kp) -> str:
    return "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                    for k in kp)


def _jspecs(tree) -> dict:
    flat = jax.tree_util.tree_leaves_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    return {_jpath(kp): tuple(v) for kp, v in flat}


def _tspecs(tree) -> dict:
    out = {}
    tsl.map_with_path(lambda p, s: out.__setitem__(p, s), tree)
    return out


@functools.lru_cache(maxsize=None)
def _jparams(name: str):
    arch = jcfgs.get(name)
    cfg = arch.model
    pol = jcommon.resolve_arch_policy(arch)
    return jax.eval_shape(
        lambda: jget_api(cfg)["init"](jax.random.key(0), cfg, pol))


@functools.lru_cache(maxsize=None)
def _tparams(name: str):
    arch = tcfgs.get(name)
    cfg = arch.model
    pol = tcommon.resolve_arch_policy(arch, device="cpu")
    with tspecs.fake_mode():
        return tget_api(cfg)["init"](0, cfg, pol, device="cpu")


@pytest.mark.parametrize("serving", [False, True])
@pytest.mark.parametrize("mesh", MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("name", jcfgs.ARCH_NAMES)
def test_param_specs_match_reference(name, mesh, serving):
    want = _jspecs(jsl.param_specs(_jparams(name), mesh, serving=serving))
    got = _tspecs(tsl.param_specs(_tparams(name), mesh, serving=serving))
    assert got == want


def _sds_tuple(shape, dtype, mesh, spec):
    return (tuple(shape), str(jax.numpy.dtype(dtype)), tuple(spec))


_DT = {torch.int32: "int32", torch.bfloat16: "bfloat16"}


@pytest.mark.parametrize("mesh", MESHES, ids=MESH_IDS)
def test_batch_specs_match_reference(mesh, monkeypatch):
    monkeypatch.setattr(jspecs, "_sds", _sds_tuple)
    n = 0
    for name, shape, _ in jcfgs.cells(include_skips=True):
        sh = jcfgs.SHAPES[shape]
        if sh.kind == "decode":
            continue
        want = jspecs.batch_specs(jcfgs.get(name), sh, mesh)
        got = tspecs.batch_specs(tcfgs.get(name), tcfgs.SHAPES[shape], mesh)
        assert {k: (a.shape, _DT[a.dtype], a.spec)
                for k, a in got.items()} == want, (name, shape)
        n += 1
    assert n == 20


def _flat_tensors(tree) -> dict:
    out = {}
    tsl.map_with_path(lambda p, t: out.__setitem__(p, t), tree)
    return out


@pytest.mark.parametrize("shape", ["decode_32k", "long_500k"])
@pytest.mark.parametrize("name", jcfgs.ARCH_NAMES)
def test_cache_specs_match_reference(name, shape):
    jstate = jspecs.decode_state_shapes(jcfgs.get(name), jcfgs.SHAPES[shape])
    tstate = tspecs.decode_state_shapes(tcfgs.get(name), tcfgs.SHAPES[shape])
    jleaves = {_jpath(kp): (tuple(v.shape), str(v.dtype)) for kp, v in
               jax.tree_util.tree_leaves_with_path(jstate)}
    tleaves = {p: ((tuple(t.shape), str(t.dtype).split(".")[-1])
                   if isinstance(t, torch.Tensor) else ((), "int32"))
               for p, t in _flat_tensors(tstate).items()}
    assert tleaves == jleaves
    for mesh in MESHES:
        want = _jspecs(jsl.cache_specs(jstate, mesh))
        got = _tspecs(tsl.cache_specs(tstate, mesh))
        assert got == want, mesh


# ---------------------------------------------------------------------------
# the reference's own cases (tests/test_distribution.py:20-76)
# ---------------------------------------------------------------------------
def test_param_specs_cover_big_matrices():
    specs = _tspecs(tsl.param_specs(_tparams("granite-8b"),
                                    FakeMesh((16, 16), ("data", "model"))))
    assert specs["embed/table"] == ("model", "data")
    assert specs["layers/0/attn/wq/w"] == ("data", "model")
    assert specs["layers/0/attn/wo/w"] == ("model", "data")
    assert specs["layers/0/mlp/wi/w"] == ("data", "model")
    assert specs["layers/0/ln1/scale"] == ()
    assert specs["lm_head/w"] == ("data", "model")


def test_moe_expert_parallel_specs():
    specs = _tspecs(tsl.param_specs(_tparams("dbrx-132b"),
                                    FakeMesh((16, 16), ("data", "model"))))
    assert specs["layers/0/moe/wi"] == ("model", "data", None)
    assert specs["layers/0/moe/wo"] == ("model", None, "data")


def test_indivisible_dims_fall_back_to_replication():
    spec = tsl._resolve(("DP", "TP"), (100, 48),
                        FakeMesh((16, 16), ("data", "model")))
    assert spec == (None, "model")


# ---------------------------------------------------------------------------
# specs -> placements
# ---------------------------------------------------------------------------
class _RankMesh(FakeMesh):
    """A duck mesh that also knows this rank's coordinate."""

    def __init__(self, shape, axes, coord):
        super().__init__(shape, axes)
        self.mesh_dim_names = axes
        self.coord = dict(zip(axes, coord))

    def get_local_rank(self, name):
        return self.coord[name]


def test_placements_split_major_to_minor():
    from torch.distributed.tensor import Replicate, Shard
    mesh = _RankMesh((2, 4, 3), ("pod", "data", "model"), (1, 2, 0))
    pl = tsl.placements((("pod", "data"), None, "model"), mesh)
    assert pl == [Shard(0), Shard(0), Shard(2)]
    assert tsl.placements((), mesh) == [Replicate()] * 3
    # the jax order: pod major, data minor -> block 1 * 4 + 2 of 8
    assert tsl.local_block(64, mesh, ("pod", "data")) == (48, 56)
    assert tsl.local_block(64, mesh, "data") == (32, 48)
    with pytest.raises(ValueError):
        tsl.placements((("data", "pod"),), mesh)


def test_probe_spec_matches_reference():
    for mesh in MESHES:
        for n, rank, axis in [(64, 2, 0), (13, 2, 0), (64, 3, 1), (7, 3, 1)]:
            assert tsl.probe_spec(mesh, n, rank, axis) == \
                tuple(jsl.probe_spec(mesh, n, rank, axis))
        for b, rank in [(256, 2), (1, 2), (32, 3)]:
            assert tsl.batch_spec(mesh, b, rank) == \
                tuple(jsl.batch_spec(mesh, b, rank))


def test_cells_match_reference():
    assert tcfgs.cells(True) == jcfgs.cells(True)
    assert tcfgs.cells(False) == jcfgs.cells(False)
    # 10 archs x 4 shapes; long_500k is skipped on the 8 archs outside
    # LONG_CONTEXT_ARCHS
    assert len(tcfgs.cells(False)) == 32 and len(tcfgs.cells(True)) == 40
    assert tcfgs.LONG_CONTEXT_ARCHS == jcfgs.LONG_CONTEXT_ARCHS
    assert tcfgs.ARCH_NAMES == jcfgs.ARCH_NAMES


def test_maybe_constrain_is_identity_without_mesh():
    x = torch.randn(4, 3, 8)
    assert tcommon.maybe_constrain(x, "data", None, None) is x
    assert tcommon.batch_sharding_axes() is None
    assert tcommon.place_state({"k": x}) == {"k": x}
