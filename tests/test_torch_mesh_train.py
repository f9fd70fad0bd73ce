"""A sharded train step on real processes: four CPU ranks over gloo (a
`FileStore` under the test's tmp_path), in a subprocess with its own
timeout (`tests/torch_mesh_worker.py DIR 4 train`).

The smoke granite-8b's f32 `train_loss`, its `backward()` and one
`adamw.apply_updates` step at 4 x 512 tokens, with the parameters placed
by `param_specs` and the batch by `batch_spec` on a (2, 2) mesh inside
`sharding.sharded_region`, give the unsharded step's loss, gradients,
first moments and updated parameters, each to 1e-5 of its leaf's largest
magnitude (the tensor-parallel partial sums add in another order).  gloo
has no all-to-all: its re-sharding leaves local gradients that are not
contiguous, which a view in DTensor's backward refused before
`ReplicateFallback` ran such a view on contiguous shards.
"""
import torch_threads  # noqa: F401  (first: torch's threads under xdist)
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
WORKER = ROOT / "tests" / "torch_mesh_worker.py"
RTOL = 1e-5


def test_four_ranks_train_step_matches_unsharded(tmp_path):
    env = dict(os.environ, OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, str(WORKER), str(tmp_path), "4",
                          "train"], env=env, capture_output=True, text=True,
                         timeout=180, cwd=ROOT)
    assert out.returncode == 0, out.stdout + out.stderr
    docs = [json.loads((tmp_path / f"rank{r}.json").read_text())
            for r in range(4)]
    for r, doc in enumerate(docs):
        err, scale = doc["train_loss"]
        assert err <= RTOL * scale, (r, doc["train_loss"])
        for name in ("train_grads", "train_mu", "train_params"):
            assert len(doc[name]) == doc["train_leaves"] > 0, (r, name)
            for i, (err, scale) in enumerate(doc[name]):
                assert err <= RTOL * scale, (r, name, i, err, scale)
        # the update moved every leaf
        assert doc["train_moved"] == doc["train_leaves"], r
        assert doc == docs[0], r
