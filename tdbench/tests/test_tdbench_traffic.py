"""The traffic generators repeat from a seed, every seed sends the same
set of lengths in another order, and the lengths are the cut log-normal's
quantiles."""
import json
import os
from statistics import NormalDist

import numpy as np
import pytest

from tdbench import harness
from tdbench.traffic import closed_loop

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
MIXES = sorted(f[:-5] for f in os.listdir(os.path.join(ROOT, "tdbench",
                                                        "traffic"))
               if f.endswith(".json"))


def _mix(name):
    return json.load(open(os.path.join(ROOT, "tdbench", "traffic",
                                       name + ".json")))


def _draw(mix, seed, rounds=3):
    """The asks of set-up and of ``rounds`` steps in which every client's
    request finishes, as (key, prompt length, output, prompt)."""
    gen = harness.load_traffic(ROOT, mix, 1000, seed)
    asks = list(gen.start())
    for _ in range(rounds):
        asks += gen.after_step(0.0, list(range(mix["clients"])))
    return [(k, len(p), o, p.tolist()) for k, p, o in asks]


@pytest.mark.parametrize("mix", MIXES)
def test_traffic_repeats_from_a_seed(mix):
    m = _mix(mix)
    seed = 2 ** 31 + 12345
    assert _draw(m, seed) == _draw(m, seed)
    assert _draw(m, seed) != _draw(m, seed + 1)   # the prompt tokens


@pytest.mark.parametrize("mix", MIXES)
def test_every_seed_has_the_same_lengths(mix):
    m = _mix(mix)
    n, pool = m["clients"], m["pool"]
    sets, orders = [], []
    for seed in (1, 2 ** 31 + 7, 99):
        a = _draw(m, seed, rounds=2 * pool)
        prompts = [x[1] for x in a]
        outs = [x[2] for x in a[n:]]
        # any pool requests sent one after another hold each length once
        for lens in (prompts, outs):
            for i in range(0, len(lens) - pool, 5):
                assert sorted(lens[i:i + pool]) == sorted(lens[:pool])
        sets.append((sorted(prompts[:pool]), sorted(outs[:pool]),
                     sorted(x[2] for x in a[:n])))
        orders.append(prompts[:pool])
    assert sets[0] == sets[1] == sets[2]
    assert len({tuple(o) for o in orders}) > 1, "the seed orders the work"
    assert max(m["prompt_len"]["max"], max(sets[0][0])) <= m["prompt_pad"]
    assert min(sets[0][1] + sets[0][2]) >= 2, "a 1-token request frees " \
        "its slot before the decode step"
    assert "loop" not in m and "order_seed" not in m


def test_lengths_are_the_cut_log_normals_quantiles():
    spec = {"median": 192, "sigma": 0.6, "min": 64, "max": 384}
    q = closed_loop.quantiles(spec, 400)
    assert q.min() >= 64 and q.max() <= 384
    assert (np.diff(q) >= 0).all()
    nd = NormalDist(np.log(192), 0.6)
    lo, hi = nd.cdf(np.log(64)), nd.cdf(np.log(384))
    for share in (0.1, 0.5, 0.9):
        want = np.exp(nd.inv_cdf(lo + share * (hi - lo)))
        assert abs(np.quantile(q, share) - want) <= 2
    # heavier to the right: the mean lies above the median
    assert q.mean() > np.median(q)
