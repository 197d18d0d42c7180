"""Data pipeline: deterministic synthetic token streams + memmap-backed files,
sharded per data-parallel host group, with background prefetch.

The synthetic stream is a fixed-seed Zipf-ish mixture so train loss curves are
reproducible across restarts (the checkpoint test resumes mid-stream by step
index — the stream is stateless-indexable, a requirement for elastic restore).

An own copy of the JAX package's ``data/pipeline.py`` (plain numpy, no
change but this paragraph): the batches are byte-equal to the JAX package's,
so a loss curve of the port and one of the JAX package see the same tokens.
"""
from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Iterator, Optional

import numpy as np


@dataclass
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    kind: str = "synthetic"        # synthetic | memmap
    path: Optional[str] = None
    dp_rank: int = 0
    dp_size: int = 1


class TokenStream:
    """Stateless-indexable batches: batch(i) is pure in (seed, i, dp_rank)."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        if cfg.kind == "memmap":
            assert cfg.path, "memmap stream needs a path"
            self._data = np.memmap(cfg.path, dtype=np.int32, mode="r")
        else:
            self._data = None
        assert cfg.global_batch % cfg.dp_size == 0
        self.local_batch = cfg.global_batch // cfg.dp_size

    def batch(self, step: int) -> dict:
        c = self.cfg
        if self._data is not None:
            n = self._data.shape[0]
            rng = np.random.default_rng((c.seed, step, c.dp_rank))
            starts = rng.integers(0, n - c.seq_len - 1, size=self.local_batch)
            toks = np.stack([self._data[s:s + c.seq_len + 1] for s in starts])
        else:
            rng = np.random.default_rng((c.seed, step, c.dp_rank))
            # Zipf-ish marginal + short-range repetition => learnable signal
            base = rng.zipf(1.3, size=(self.local_batch, c.seq_len + 1))
            toks = (base % (c.vocab_size - 2)) + 2
            rep = rng.random((self.local_batch, c.seq_len + 1)) < 0.3
            toks[:, 1:][rep[:, 1:]] = toks[:, :-1][rep[:, 1:]]   # bigram signal
        toks = toks.astype(np.int32)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def __iter__(self) -> Iterator[dict]:
        step = 0
        while True:
            yield self.batch(step)
            step += 1


class Prefetcher:
    """Background-thread prefetch (double buffering on the host)."""

    def __init__(self, stream: TokenStream, start_step: int = 0, depth: int = 2):
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()

        def worker():
            step = start_step
            while not self._stop.is_set():
                try:
                    self.q.put(stream.batch(step), timeout=0.5)
                    step += 1
                except queue.Full:
                    continue

        self._t = threading.Thread(target=worker, daemon=True)
        self._t.start()

    def next(self) -> dict:
        return self.q.get()

    def stop(self):
        self._stop.set()
