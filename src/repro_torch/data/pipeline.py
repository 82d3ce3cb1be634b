"""Deterministic synthetic LM data pipeline.

Port of ``src/repro/data/pipeline.py``: a plain numpy copy (the reference
module imports no JAX, but the port imports nothing of the JAX package).
It generates a seeded Zipf-distributed token stream with injected local
structure (repeated n-grams) so the loss is learnable, packs it into
[global_batch, seq_len] examples with masks, and iterates host-side numpy
batches (device placement is the trainer's job).  Batches equal the
reference's bit for bit for any ``(seed, step)``.

``frontend_stub`` seeds its generator with ``hash(kind) & 0xFFFF``, as the
reference does: Python salts ``str`` hashes per process unless
``PYTHONHASHSEED`` is fixed, so the stub differs from one process to the
next, and the two packages' stubs agree within one process.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.3
    ngram_frac: float = 0.3    # fraction of positions covered by n-grams
    ngram_len: int = 8
    n_ngrams: int = 256


class SyntheticLM:
    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        self._ngrams = rng.integers(
            2, cfg.vocab, (cfg.n_ngrams, cfg.ngram_len)).astype(np.int32)

    def _sample_tokens(self, rng: np.random.Generator, n: int) -> np.ndarray:
        c = self.cfg
        toks = rng.zipf(c.zipf_a, n).astype(np.int64) % (c.vocab - 2) + 2
        # paste n-grams over random spans: learnable local structure
        n_spans = int(n * c.ngram_frac / c.ngram_len)
        if n_spans:
            starts = rng.integers(0, max(n - c.ngram_len, 1), n_spans)
            which = rng.integers(0, c.n_ngrams, n_spans)
            for s, w in zip(starts, which):
                toks[s:s + c.ngram_len] = self._ngrams[w]
        return toks.astype(np.int32)

    def batches(self, *, start_step: int = 0) -> Iterator[dict]:
        c = self.cfg
        step = start_step
        while True:
            rng = np.random.default_rng((c.seed, step))
            n = c.global_batch * c.seq_len
            toks = self._sample_tokens(rng, n)
            tokens = toks.reshape(c.global_batch, c.seq_len)
            mask = np.ones_like(tokens, np.int32)
            yield {"tokens": tokens, "mask": mask, "step": step}
            step += 1


def frontend_stub(kind: str, batch: int, length: int, dim: int,
                  seed: int = 0) -> np.ndarray:
    """Precomputed frame/patch embeddings for [audio]/[vlm] frontends:
    deterministic pseudo-embeddings with realistic scale and smoothness
    (seeded by ``hash(kind)``: see the module docstring)."""
    rng = np.random.default_rng((hash(kind) & 0xFFFF, seed))
    x = rng.standard_normal((batch, length, dim)).astype(np.float32)
    # temporal smoothing: neighboring frames/patches correlate
    k = 5
    kern = np.hanning(k)[None, :, None]
    kern = kern / kern.sum()
    pad = np.pad(x, ((0, 0), (k // 2, k // 2), (0, 0)), mode="edge")
    sm = sum(pad[:, i:i + length] * kern[:, i] for i in range(k))
    return sm.astype(np.float32)
