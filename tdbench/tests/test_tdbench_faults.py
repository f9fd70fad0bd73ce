"""A run whose timed path is broken underneath reads ``correct`` false:
a decode step that returns its state unchanged, half of the batch left
out, a token altered where it is produced.  (One chip: no exchange
between chips to leave out.)"""
import time

import pytest
import torch

from tdbench import harness
from tdbench.tests import smoke


def _stale_state(run):
    eng = run.engine
    orig = eng._decode

    def step(params, tok, state):
        nxt, _ = orig(params, tok, state)
        return nxt, state            # the caches' fill index never moves
    eng._decode = step


def _half_batch(run):
    eng = run.engine
    orig = eng._decode

    def step(params, tok, state):
        nxt, new = orig(params, tok, state)
        half = nxt.shape[0] // 2
        nxt = nxt.clone()
        nxt[half:] = tok[half:]      # the rows past half never computed
        return nxt, new
    eng._decode = step


def _token_altered(run):
    eng = run.engine
    vocab = run.mc["vocab"]
    pre, dec = eng._prefill, eng._decode

    def prefill(params, toks, true_len):
        tok, state = pre(params, toks, true_len)
        return (tok + 1) % vocab, state

    def step(params, tok, state):
        nxt, new = dec(params, tok, state)
        return (nxt + 1) % vocab, new
    eng._prefill, eng._decode = prefill, step


@pytest.mark.parametrize("fault", [_stale_state, _half_batch,
                                   _token_altered],
                         ids=["state_unchanged", "half_batch",
                              "token_altered"])
@pytest.mark.parametrize("moe", [False, True], ids=["dense", "moe"])
def test_a_broken_timed_path_is_not_correct(fault, moe):
    res, _ = harness.run_cell(smoke.cell(moe=moe), 2 ** 31 + 99, 4.0, False,
                              torch.device("cpu"), time.monotonic(),
                              hook=fault)
    assert not res["correct"]
    assert any(c["value"] > c["limit"] for c in res["checks"].values())
