"""Port parity of the enc-dec family's entry points on the CPU: the
seamless-m4t-large-v2 smoke model through the port's `serve.run` and
`train.run` (and their CLIs), on the reference's converted init
(`torch_launch_parity`), float32 compute, quant mode.

* `serve.run`, batch 2, prompt 8, 6 new tokens, 8 frames of embeddings
  (`serve.frontend_embeds`, bf16): tokens identical to the reference's
  jitted prefill and serve steps on the same prompts and frames;
* `train.run`, 2 steps of 4 x 16 tokens with 4 frames a row
  (`SyntheticStream.frontend_batch`) in 2 microbatches: losses within
  1e-5 relative of the reference's `train.run` (its jitted step);
* the serve and train CLIs (``--smoke --device cpu``) at td: tokens in
  range, finite losses.
"""
import torch_threads  # noqa: F401  (first: torch's threads under xdist)
import numpy as np

from repro_torch.launch import serve as tserve
from repro_torch.launch import train as ttrain

from torch_launch_parity import serve_both, train_both

NAME = "seamless-m4t-large-v2"


def test_serve_run_matches_reference_steps(monkeypatch):
    got, want, n_front = serve_both(NAME, 2, 8, 6, monkeypatch)
    assert n_front == 8 and got.shape == (2, 6)
    np.testing.assert_array_equal(got, want)


def test_train_run_matches_reference_run(monkeypatch):
    tl, jl = train_both(NAME, 2, 16, 4, monkeypatch, n_micro=2)
    assert len(tl) == 2 and np.all(np.isfinite(tl))
    np.testing.assert_allclose(tl, jl, rtol=1e-5)


def test_serve_and_train_clis_on_cpu(capsys):
    ids = tserve.main(["--smoke", "--arch", NAME, "--td", "td", "--device",
                       "cpu", "--batch", "2", "--prompt-len", "6", "--gen",
                       "3"])
    assert ids.shape == (2, 3)
    assert int(ids.min()) >= 0 and int(ids.max()) < 128
    losses = ttrain.main(["--smoke", "--arch", NAME, "--td", "td",
                          "--steps", "1", "--seq", "16", "--batch", "4",
                          "--device", "cpu"])
    assert len(losses) == 1 and np.all(np.isfinite(losses))
    assert "[train] done." in capsys.readouterr().out
