"""Deterministic synthetic token pipeline (the port's copy of
`repro/data/synthetic.py`: numpy only, the same batches bit for bit).

Stateless-resumable: batch t of the stream is a pure function of
(seed, step, dp_rank), so checkpoint restore needs no data-loader state and
elastic remesh (different dp_rank count) keeps determinism per rank.

The stream is not uniform noise: documents are Zipf-ish token draws with
bos/eos structure and a repeated-ngram backbone so the LM loss actually
decreases during the example runs (pure uniform noise has no learnable
signal).
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataCfg:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 1234
    bos: int = 1
    eos: int = 2
    zipf_a: float = 1.2
    motif_len: int = 16
    motif_period: int = 64


def _zipf_probs(cfg: DataCfg) -> np.ndarray:
    ranks = np.arange(3, cfg.vocab, dtype=np.float64)
    p = 1.0 / np.power(ranks - 2, cfg.zipf_a)
    probs = np.zeros(cfg.vocab)
    probs[3:] = p / p.sum()
    return probs


class SyntheticStream:
    """Host-side generator; per-rank sharded slices of the global batch."""

    def __init__(self, cfg: DataCfg, dp_rank: int = 0, dp_size: int = 1):
        assert cfg.global_batch % dp_size == 0
        self.cfg = cfg
        self.dp_rank = dp_rank
        self.dp_size = dp_size
        self.local_batch = cfg.global_batch // dp_size
        self._probs = _zipf_probs(cfg)

    def batch(self, step: int) -> dict:
        cfg = self.cfg
        rng = np.random.default_rng(
            np.random.SeedSequence([cfg.seed, step, self.dp_rank]))
        b, s = self.local_batch, cfg.seq_len
        toks = rng.choice(cfg.vocab, size=(b, s + 1), p=self._probs)
        # motif backbone: periodic repeated n-grams (learnable structure)
        motif = rng.choice(cfg.vocab, size=(b, cfg.motif_len),
                           p=self._probs)
        for off in range(0, s + 1 - cfg.motif_len, cfg.motif_period):
            toks[:, off:off + cfg.motif_len] = motif
        # document structure
        doc_len = rng.integers(64, max(65, s // 2))
        toks[:, 0] = cfg.bos
        for pos in range(doc_len, s + 1, doc_len):
            toks[:, pos - 1] = cfg.eos
            if pos < s + 1:
                toks[:, pos] = cfg.bos
        return {"tokens": toks[:, :-1].astype(np.int32),
                "labels": toks[:, 1:].astype(np.int32)}

    def frontend_batch(self, step: int, n_positions: int,
                       d_frontend: int) -> np.ndarray:
        """Stub modality embeddings (precomputed patch/frame features)."""
        rng = np.random.default_rng(
            np.random.SeedSequence([self.cfg.seed, step, self.dp_rank, 7]))
        return rng.standard_normal(
            (self.local_batch, n_positions, d_frontend)).astype(np.float32)
