"""Synthetic traffic: seeded Poisson arrivals, mixed request shapes.

One :func:`generate` call produces a deterministic trace — a list of
:class:`~repro_torch.serve.request.Request` with exponential inter-arrival
times (Poisson process at ``rate`` req/s) and prompt/output lengths
drawn from seeded mixed distributions. Determinism matters twice: the
CI smoke scenario gates tokens/sec on a fixed trace, and the harness
replays the *same* trace (via :meth:`Request.fresh`) under continuous
and serial scheduling to compute the speedup honestly.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

import numpy as np

from .request import Request

__all__ = ["TrafficConfig", "generate"]


@dataclass(frozen=True)
class TrafficConfig:
    """Shape of a synthetic trace.

    ``rate`` is the Poisson arrival rate (requests/second);
    ``prompt_lens`` and ``output_lens`` are the discrete supports the
    per-request prompt length and decode budget are drawn from
    (uniformly — a crude stand-in for the mixed short-chat / long-doc
    population real serving sees). Prompt *elements* are drawn below
    ``2^(n_bits-2)`` so the carry-save accumulator's u-stream can't
    overflow (see :mod:`repro_torch.serve.sequence`).
    """

    n_requests: int = 16
    rate: float = 200.0
    prompt_lens: Tuple[int, ...] = (2, 4, 8)
    output_lens: Tuple[int, ...] = (1, 2, 4)
    n_bits: int = 8
    seed: int = 0


def generate(cfg: TrafficConfig) -> List[Request]:
    """Deterministic request trace for ``cfg`` (same cfg, same trace)."""
    rng = np.random.default_rng(cfg.seed)
    hi = 1 << max(1, cfg.n_bits - 2)
    t = 0.0
    reqs: List[Request] = []
    for rid in range(cfg.n_requests):
        t += float(rng.exponential(1.0 / cfg.rate))
        plen = int(rng.choice(cfg.prompt_lens))
        olen = int(rng.choice(cfg.output_lens))
        prompt = tuple(int(v) for v in rng.integers(0, hi, plen))
        reqs.append(Request(rid=rid, arrival=t, prompt=prompt,
                            max_new_tokens=olen, seed=cfg.seed))
    return reqs
