"""The port's sharding on real processes: four CPU ranks over gloo (a
`FileStore` under the test's tmp_path, so no TCP port is shared between
xdist workers), in a subprocess with its own timeout
(`tests/torch_mesh_worker.py`).

* The smoke decoder's forward with its parameters placed by
  `param_specs` on a (2, 2) mesh equals the unsharded forward (f32, to
  1e-5 of the logits' largest magnitude: the tensor-parallel partial sums
  add in another order).
* `find_sigma_max_batched(mesh=)` on a (4, 1) mesh, whole and chunked (a
  chunk of 4 split over the ranks, a chunk of 3 replicated), is bit for
  bit the unsharded call, noise included.
* `ckpt.restore(shardings=)` restores onto placements bit for bit, from
  specs and from tuples of placements.
* On a (1, 1) mesh the search of the reference's `TestMeshShardedProbes`
  (tests/test_td_vmm_engine.py:204-230) equals the unsharded one bit for
  bit, and the reference's to its noise's last ulps; the smoke qwen3-8b
  served there in td mode (`serve.run(mesh=)`) gives the plain serve's
  tokens and logits bit for bit.
* The gradients of a loss over the smoke-sized embedding table and an
  lm_head on a (2, 2) mesh, at enough ids that DTensor splits the table
  over its vocabulary (a masked partial lookup), equal the unsharded
  ones to 1e-5 of their scale.
"""
import torch_threads  # noqa: F401  (first: torch's threads under xdist)
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np

ROOT = Path(__file__).resolve().parents[1]
WORKER = ROOT / "tests" / "torch_mesh_worker.py"


def _run(tmp_path, world: int, timeout: float, *mode: str) -> list:
    env = dict(os.environ, OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, str(WORKER), str(tmp_path),
                          str(world), *mode], env=env, capture_output=True,
                         text=True, timeout=timeout, cwd=ROOT)
    assert out.returncode == 0, out.stdout + out.stderr
    return [json.loads((tmp_path / f"rank{r}.json").read_text())
            for r in range(world)]


def test_four_ranks_forward_search_restore(tmp_path):
    docs = _run(tmp_path, 4, timeout=240)
    for r, doc in enumerate(docs):
        assert doc["forward_close"], (r, doc["forward_max_err"],
                                      doc["forward_scale"])
        assert doc["sharded_leaves"] > 0
        assert doc["search_eq"] == {"chunk None": True, "chunk 4": True,
                                    "chunk 3": True}, r
        assert doc["restore_step"] == 3 and doc["restore_leaves"] > 0
        assert doc["restore_equal"] and doc["restore_placed"], r
        assert doc["restore_by_placements"], r
    # every rank gathered the same accuracies
    assert all(d["search"] == docs[0]["search"] for d in docs)
    assert np.isfinite(docs[0]["search"]["sigma_max"]).all()


def test_one_device_mesh_matches_reference(tmp_path):
    from repro.core import noise_tolerance as jnt
    from test_td_vmm_engine import _probe_eval
    doc = _run(tmp_path, 1, timeout=120)[0]
    for name in ("meshed", "chunked"):
        assert doc[name] == doc["plain"], name
    assert doc["serve"] == {"tokens_equal": True, "logits_equal": True,
                            "steps": 6}
    want = jnt.find_sigma_max_batched(_probe_eval, sigmas=[0.5, 2.0, 8.0],
                                      key=jax.random.PRNGKey(0), n_layers=1,
                                      n_repeats=2)
    np.testing.assert_array_equal(doc["plain"]["sigma_max"],
                                  np.asarray(want.sigma_max))
    np.testing.assert_allclose(doc["plain"]["acc_clean"],
                               np.asarray(want.acc_clean), rtol=1e-6)
    np.testing.assert_allclose(doc["plain"]["rel_drop"],
                               np.asarray(want.rel_drop), rtol=1e-5,
                               atol=1e-7)


def test_four_ranks_vocab_split_lookup_gradient(tmp_path):
    docs = _run(tmp_path, 4, 120, "embed")
    for r, doc in enumerate(docs):
        for err, scale in doc["embed_grad"]:
            # f32; the sharded sums add in another order
            assert err <= 1e-5 * scale, (r, doc["embed_grad"])
