"""The port's dry run (`python -m repro_torch.launch.dryrun`) on the CPU,
each run in a subprocess of its own (the ``fake`` process group comes up
at the mesh's size as the process starts) with its own timeout.

* The reference's two small-mesh cells (tests/test_distribution.py:
  119-143: granite-moe-1b-a400m decode_32k, rwkv6-1.6b train_4k),
  zamba2-1.2b long_500k and rwkv6-1.6b decode_32k, full configs on a (2,
  4) fake mesh: a complete artifact, ``dominant`` in the set,
  ``flops_per_chip`` > 0.
* The smoke granite-8b prefill_32k, where every dimension divides the
  mesh: its matmul FLOPs per chip times the chips on (2, 2) equal the
  (1, 1) count within 1%.
* The smoke `train_4k` cells of qwen3-8b, granite-8b and
  granite-moe-1b-a400m on a (2, 2) fake mesh, where DTensor splits the
  small embedding table over its vocabulary and the lookup's gradient
  must come back through that split: rc 0 and a complete artifact.
"""
import torch_threads  # noqa: F401  (first: torch's threads under xdist)
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
KEYS = ("n_params", "flops_per_chip", "bytes_per_chip", "collectives",
        "coll_operand_bytes_total", "coll_link_bytes_total",
        "scan_corrections", "model_flops", "roofline", "memory")


def _dryrun(tmp_path, devices: int, *args, timeout: float = 300) -> dict:
    env = dict(os.environ, REPRO_DRYRUN_DEVICES=str(devices),
               PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--mesh",
         "small", "--out", str(tmp_path), *args],
        env=env, capture_output=True, text=True, timeout=timeout, cwd=ROOT)
    assert out.returncode == 0, out.stdout + out.stderr
    files = list(tmp_path.iterdir())
    assert len(files) == 1
    return json.loads(files[0].read_text())


@pytest.mark.parametrize("arch,shape", [
    ("granite-moe-1b-a400m", "decode_32k"),
    ("rwkv6-1.6b", "train_4k"),
    ("zamba2-1.2b", "long_500k"),
    # rwkv6's decode matmul meets DTensor's strided shards: their gather
    # under fake tensors (`sharding._gathered_fake`)
    ("rwkv6-1.6b", "decode_32k"),
])
def test_small_mesh_cell(arch, shape, tmp_path):
    res = _dryrun(tmp_path, 8, "--arch", arch, "--shape", shape)
    assert res["ok"] and res["chips"] == 8 and res["mesh"] == "small_2x4"
    for k in KEYS:
        assert k in res, k
    rl = res["roofline"]
    assert rl["dominant"] in ("compute", "memory", "collective")
    assert res["flops_per_chip"] > 0 and rl["step_s"] > 0
    assert res["memory"]["peak_bytes"] > res["memory"]["params_bytes"] > 0
    assert isinstance(res["memory"]["fits"], bool)
    assert "not a measurement" in res["modelled"]
    if shape == "train_4k":
        # rwkv6's time loop counted as one step times its 4096 steps, in
        # each layer's forward and its recompute (remat "full")
        assert res["scan_corrections"]["scans"] == {"wkv6": 2 * 24 * 4096}
        assert res["collectives"]["counts"]["reduce-scatter"] > 0
    elif arch == "rwkv6-1.6b":
        # attention-free: no kernel, the strided layouts gathered
        assert res["scan_corrections"]["kernels_per_chip"] == {}
        assert res["collectives"]["counts"]["all-gather"] > 0
    else:
        kern = res["scan_corrections"]["kernels_per_chip"]
        assert kern["decode_gqa"]["calls"] > 0


def test_flops_per_chip_times_chips_equal_one_device(tmp_path):
    args = ("--arch", "granite-8b", "--shape", "prefill_32k", "--smoke")
    (tmp_path / "a").mkdir()
    (tmp_path / "b").mkdir()
    one = _dryrun(tmp_path / "a", 1, *args)
    four = _dryrun(tmp_path / "b", 4, *args)
    assert one["chips"] == 1 and four["chips"] == 4
    mm1 = one["op_flops"]["mm"]
    mm4 = four["op_flops"]["mm"] * four["chips"]
    assert mm4 == pytest.approx(mm1, rel=0.01)
    assert one["collectives"]["counts"] == {
        k: 0 for k in one["collectives"]["counts"]}


@pytest.mark.parametrize("arch", ["qwen3-8b", "granite-8b",
                                  "granite-moe-1b-a400m"])
def test_smoke_train_4k_small_mesh(arch, tmp_path):
    res = _dryrun(tmp_path, 4, "--arch", arch, "--shape", "train_4k",
                  "--smoke", timeout=120)
    assert res["ok"] and res["chips"] == 4 and res["mesh"] == "small_2x2"
    for k in KEYS:
        assert k in res, k
    assert res["flops_per_chip"] > 0 and res["roofline"]["step_s"] > 0
    assert res["collectives"]["counts"]["all-reduce"] > 0
