"""Deterministic, seekable synthetic token pipeline (the port's own copy
of the JAX package's ``data/pipeline.py``, numpy only: the same batch
for every ``(seed, step, host)``).

Fault-tolerance primitive: every batch is a pure function of
(seed, step, host) via a counter-based hash, so restart-after-preemption
resumes *exactly* at the failed step with no data replay and no state to
checkpoint beyond the integer step. Host-sharding splits the global
batch across data-parallel hosts.

The token stream is a stationary-AR synthetic language (per-sequence
Markov chain over the vocab) rather than iid noise, so cross-entropy has
learnable structure and training-loss curves are meaningful.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    n_hosts: int = 1
    host_id: int = 0
    order: int = 2          # Markov order of the synthetic language


def _philox(seed: int, step: int, host: int, n: int) -> np.random.Generator:
    return np.random.default_rng(
        np.random.SeedSequence(entropy=seed,
                               spawn_key=(step, host)))


class SyntheticLM:
    """Counter-based synthetic LM data: batch(step) is pure & seekable."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        assert cfg.global_batch % cfg.n_hosts == 0
        self.local_batch = cfg.global_batch // cfg.n_hosts
        # fixed random Markov transition structure (shared across hosts)
        rng = np.random.default_rng(cfg.seed)
        k = min(cfg.vocab, 64)
        self._proj = rng.integers(0, cfg.vocab, size=(k,), dtype=np.int64)
        self._mix = rng.integers(1, 2**31 - 1, size=(cfg.order,),
                                 dtype=np.int64)

    def batch(self, step: int) -> dict:
        """-> {'tokens': (B_local, S) int32, 'labels': same, shifted}."""
        cfg = self.cfg
        rng = _philox(cfg.seed, step, cfg.host_id, 0)
        b, s = self.local_batch, cfg.seq_len
        noise = rng.integers(0, cfg.vocab, size=(b, s + 1), dtype=np.int64)
        toks = np.empty((b, s + 1), dtype=np.int64)
        toks[:, :cfg.order] = noise[:, :cfg.order]
        k = len(self._proj)
        for t in range(cfg.order, s + 1):
            h = np.zeros(b, dtype=np.int64)
            for j, m in enumerate(self._mix):
                h = h * 1000003 + toks[:, t - 1 - j] * int(m)
            det = self._proj[np.abs(h) % k]
            use_noise = (noise[:, t] % 5) == 0        # 20% noise
            toks[:, t] = np.where(use_noise, noise[:, t] % cfg.vocab, det)
        return {"tokens": toks[:, :-1].astype(np.int32),
                "labels": toks[:, 1:].astype(np.int32)}

    def iter_from(self, step: int) -> Iterator[dict]:
        while True:
            yield self.batch(step)
            step += 1


class PrefetchIterator:
    """Background-thread prefetch (overlap host data gen with device step)."""

    def __init__(self, it: Iterator[dict], depth: int = 2):
        import queue
        import threading
        self._q = queue.Queue(maxsize=depth)
        self._it = it
        self._done = False

        def worker():
            for item in it:
                if self._done:
                    return
                self._q.put(item)

        self._t = threading.Thread(target=worker, daemon=True)
        self._t.start()

    def __iter__(self):
        return self

    def __next__(self):
        return self._q.get()

    def close(self):
        self._done = True
