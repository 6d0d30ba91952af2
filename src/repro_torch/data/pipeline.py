"""Deterministic synthetic data pipeline (host-sharded, prefetching).

The port's copy of ``repro.data.pipeline``, numpy only and unchanged:
the same config and step give byte-identical batches in both packages.

Real-cluster behaviour without external datasets: tokens are a
counter-hashed stream, so (a) every host can materialize exactly its own
shard without coordination, (b) restarts resume bit-identically from the
step counter (checkpoint stores only ``step``), and (c) loss curves are
reproducible across mesh shapes. The pipeline packs documents of
geometric length with EOS separators so the distribution isn't trivially
uniform (attention sees real boundary structure).
"""
from __future__ import annotations

import threading
import queue
from dataclasses import dataclass
from typing import Dict, Iterator, Optional

import numpy as np

__all__ = ["DataConfig", "SyntheticStream", "make_batch_fn"]


@dataclass(frozen=True)
class DataConfig:
    """Vocabulary, sequence length, global batch, seed, EOS id and mean
    document length of a synthetic stream."""

    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    eos_id: int = 2
    mean_doc_len: int = 256


class SyntheticStream:
    """step -> {tokens, labels} (numpy), deterministically."""

    def __init__(self, cfg: DataConfig, host_index: int = 0,
                 host_count: int = 1):
        assert cfg.global_batch % host_count == 0
        self.cfg = cfg
        self.host_index = host_index
        self.host_count = host_count
        self.local_batch = cfg.global_batch // host_count

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        """This host's rows of global step ``step``: ``tokens`` and
        ``labels`` (the tokens shifted by one), int32."""
        c = self.cfg
        rows = []
        base = step * c.global_batch + self.host_index * self.local_batch
        for r in range(self.local_batch):
            rng = np.random.default_rng((c.seed, base + r))
            toks = rng.integers(3, c.vocab_size, c.seq_len + 1,
                                dtype=np.int32)
            # EOS document boundaries (geometric lengths)
            p = 1.0 / max(2, c.mean_doc_len)
            eos = rng.random(c.seq_len + 1) < p
            toks[eos] = c.eos_id
            rows.append(toks)
        arr = np.stack(rows)
        return {"tokens": arr[:, :-1], "labels": arr[:, 1:]}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


class _Prefetcher:
    """Background-thread prefetch (depth-2) over a stream."""

    def __init__(self, stream: SyntheticStream, start_step: int = 0,
                 depth: int = 2):
        self.q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()

        def worker():
            step = start_step
            while not self._stop.is_set():
                self.q.put((step, stream.batch_at(step)))
                step += 1

        self.t = threading.Thread(target=worker, daemon=True)
        self.t.start()

    def next(self):
        """The next (step, batch)."""
        return self.q.get()

    def close(self):
        """Stop the worker and drop what it queued."""
        self._stop.set()
        try:
            while True:
                self.q.get_nowait()
        except queue.Empty:
            pass


def make_batch_fn(cfg: DataConfig, extra: Optional[Dict] = None):
    """Returns step -> numpy batch, adding stubbed modality inputs."""
    stream = SyntheticStream(cfg)

    def fn(step: int) -> Dict[str, np.ndarray]:
        b = stream.batch_at(step)
        if extra:
            rng = np.random.default_rng((cfg.seed + 1, step))
            for name, shape in extra.items():
                b[name] = rng.standard_normal(
                    (cfg.global_batch,) + tuple(shape)).astype(np.float32)
        return b
    return fn
