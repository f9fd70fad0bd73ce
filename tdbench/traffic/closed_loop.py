"""Closed-loop clients: ``clients`` of them, each sending its next request
as soon as its last one has finished, so that as many requests as there
are clients are always in the system.

Lengths are heavy-tailed: log-normal, the shape of the prompt and output
lengths of the Azure LLM inference traces (github.com/Azure/AzurePublicDataset),
cut to the mix's range, whose top is the prefill bucket for prompts.  A
mix gives each as ``{"median", "sigma", "min", "max"}``.  The ``pool``
lengths are the cut log-normal's quantiles at (i + 1/2) / pool, the same
for every seed.  The seed permutes them, and each request, in the order
the clients send them, takes the next of the permuted prompt lengths and
the next of the permuted output lengths, cycling: any ``pool`` requests
sent one after another hold each length once, so a seed changes the order
of the work and not its amount.  The clients' first requests (the
set-up's fill of every slot) take output lengths spread evenly over
``first_output_len``, in the seed's order, so that completions are spread
from the start.  Prompt tokens are uniform over the vocabulary, drawn from
the seed in the order the requests are sent.

The harness calls ``start()`` once at set-up and ``after_step(now,
finished)`` after every engine step with the keys (here: the clients) of
the requests that finished in it; each returns the requests to send now
as ``(key, prompt, max_new_tokens)``.
"""
from __future__ import annotations

import math
from statistics import NormalDist

import numpy as np


def quantiles(spec: dict, n: int) -> np.ndarray:
    """n lengths: the quantiles at (i + 1/2) / n of a log-normal with the
    spec's median and sigma, cut to [min, max]."""
    nd = NormalDist(math.log(spec["median"]), spec["sigma"])
    lo, hi = spec["min"], spec["max"]
    flo, fhi = nd.cdf(math.log(lo)), nd.cdf(math.log(hi))
    u = flo + (np.arange(n) + 0.5) / n * (fhi - flo)
    q = [round(math.exp(nd.inv_cdf(float(x)))) for x in u]
    return np.clip(np.asarray(q, np.int64), lo, hi)


def evenly(lo: int, hi: int, n: int) -> np.ndarray:
    """n lengths spread evenly over [lo, hi]."""
    i = np.arange(n)
    return (lo + np.floor((i + 0.5) * (hi - lo + 1) / n)).astype(np.int64)


class Traffic:
    def __init__(self, mix: dict, vocab: int, seed: int):
        rng = np.random.default_rng([int(seed) % (2 ** 63), 7])
        self.prompts = rng.permutation(quantiles(mix["prompt_len"],
                                                 mix["pool"]))
        self.outs = rng.permutation(quantiles(mix["output_len"],
                                              mix["pool"]))
        self.first = rng.permutation(evenly(*mix["first_output_len"],
                                            mix["clients"]))
        self.tok = np.random.default_rng([int(seed) % (2 ** 63), 11])
        self.vocab = vocab
        self.clients = mix["clients"]
        self.n_prompts = self.n_outs = 0
        self.max_context = mix["prompt_len"]["max"] + max(
            mix["output_len"]["max"], mix["first_output_len"][1])

    def _ask(self, client: int, out: int) -> tuple:
        plen = int(self.prompts[self.n_prompts % len(self.prompts)])
        self.n_prompts += 1
        prompt = self.tok.integers(1, self.vocab, size=plen,
                                   dtype=np.int64).astype(np.int32)
        return client, prompt, out

    def start(self) -> list:
        return [self._ask(c, int(self.first[c])) for c in range(self.clients)]

    def after_step(self, now: float, finished: list) -> list:
        asks = []
        for c in finished:
            out = int(self.outs[self.n_outs % len(self.outs)])
            self.n_outs += 1
            asks.append(self._ask(c, out))
        return asks
