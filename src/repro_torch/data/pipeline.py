"""Deterministic, resumable, shard-aware data pipeline (a copy of
``repro.data.pipeline``: numpy only, each batch bit-equal to the
reference's for the same arguments).

Two sources behind one interface:

- :class:`SyntheticLM` — stateless synthetic token streams: batch(step)
  is a pure function of (seed, step), so resume-after-preemption is
  exact with zero pipeline state to checkpoint, and every data-parallel
  host computes only its own shard.
- :class:`MemmapLM` — tokenized corpus in a flat uint16/uint32 binary
  (numpy memmap); deterministic strided sampling indexed by step.

Both emit next-token-prediction batches {tokens, labels} and support
``host_slice`` so each process materializes 1/N of the global batch
(the multi-host input path; on one process the slice is everything).
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np

__all__ = ["SyntheticLM", "MemmapLM", "make_pipeline"]


@dataclasses.dataclass
class SyntheticLM:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    #: this host's slice of the global batch [lo, hi)
    host_lo: int = 0
    host_hi: int | None = None

    def __post_init__(self):
        if self.host_hi is None:
            self.host_hi = self.global_batch

    def batch(self, step: int) -> dict[str, np.ndarray]:
        """Markov-ish synthetic stream (learnable, non-uniform): token
        t+1 = (a*t + noise) % V so models show decreasing loss."""
        n = self.host_hi - self.host_lo
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step, self.host_lo]))
        first = rng.integers(0, self.vocab_size, size=(n, 1))
        noise = rng.integers(0, 7, size=(n, self.seq_len))
        toks = np.zeros((n, self.seq_len + 1), np.int64)
        toks[:, :1] = first
        for t in range(self.seq_len):
            toks[:, t + 1] = (toks[:, t] * 31 + 7 + noise[:, t] % 3) \
                % self.vocab_size
        return {"tokens": toks[:, :-1].astype(np.int32),
                "labels": toks[:, 1:].astype(np.int32)}

    def state(self) -> dict:
        return {"kind": "synthetic", "seed": self.seed}


@dataclasses.dataclass
class MemmapLM:
    path: str
    vocab_size: int
    seq_len: int
    global_batch: int
    dtype: str = "uint16"
    seed: int = 0
    host_lo: int = 0
    host_hi: int | None = None

    def __post_init__(self):
        self._data = np.memmap(self.path, dtype=self.dtype, mode="r")
        self._n_windows = (len(self._data) - 1) // self.seq_len
        if self.host_hi is None:
            self.host_hi = self.global_batch

    def batch(self, step: int) -> dict[str, np.ndarray]:
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step]))
        idx = rng.integers(0, self._n_windows, size=self.global_batch)
        idx = idx[self.host_lo:self.host_hi]
        rows = np.stack([
            self._data[i * self.seq_len: i * self.seq_len + self.seq_len + 1]
            for i in idx]).astype(np.int64)
        rows %= self.vocab_size
        return {"tokens": rows[:, :-1].astype(np.int32),
                "labels": rows[:, 1:].astype(np.int32)}

    def state(self) -> dict:
        return {"kind": "memmap", "path": self.path, "seed": self.seed}


def make_pipeline(kind: str = "synthetic", **kw):
    if kind == "synthetic":
        return SyntheticLM(**kw)
    if kind == "memmap":
        return MemmapLM(**kw)
    raise KeyError(kind)
