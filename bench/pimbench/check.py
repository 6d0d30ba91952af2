"""Whether the timed path produced the right tokens: the comparison with
the plain reference (``bench/reference``).

For a job the reference is run once, teacher-forced over the prompts and
the served tokens fed back, with each PIM projection's activation scale
over the rows of one of the program's calls (the prefill, then each
decode step). At every prompt position the program's greedy choice (the
argmax of its prefill logits; at the last position the token it served)
and at every decode position its served token are held against the
reference's logits: the gap by which the logit of the program's choice
lies below the reference's best (0 where they choose alike). A cell's
``bench/limits/<cell>.json`` names the numbers compared and their
limits, among :func:`_stats`' readings.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

__all__ = ["job_inputs", "gaps", "control_gaps", "combine", "pick_jobs",
           "judge"]


def job_inputs(job, device):
    """(tokens (B, S), call starts, read positions (S,), choices (B, S))
    of a served job: the prompts and every served token but the last fed
    back; the prefill at position 0, a decode step at each later one; the
    program's choice at each position: its prefill's argmax before the
    last prompt position, then each token it served."""
    served = torch.as_tensor(job.tokens(), device=device).long()
    prompts = job.prompts.to(device).long()
    b, p = prompts.shape
    n = served.shape[1]
    tokens = torch.cat([prompts, served[:, :n - 1]], dim=1)
    starts = [0] + list(range(p, p + n - 1))
    rows = torch.arange(p + n - 1, device=device)
    choices = torch.cat([job.prefill_choice[:, :p - 1].to(device).long(),
                         served], dim=1)
    return tokens, starts, rows, choices


def _stats(gap: torch.Tensor, p: int) -> Dict[str, float]:
    """Per part of the positions (``prefill``: the prompt's, ``decode``:
    the served tokens'), of the gaps (B, S): the widest (``gap_max``),
    the mean (``gap_mean``) and the share of positions where the choice
    is not the reference's best (``mismatch``), and the positions."""
    out: Dict[str, float] = {}
    for part, g in (("prefill", gap[:, :p]), ("decode", gap[:, p:])):
        n = g.numel()
        out[f"gap_max.{part}"] = float(g.max()) if n else 0.0
        out[f"gap_mean.{part}"] = float(g.mean()) if n else 0.0
        out[f"mismatch.{part}"] = float((g > 0).float().mean()) if n else 0.0
        out[f"positions.{part}"] = n
    return out


def gaps(ref, job, device) -> Dict[str, float]:
    """The job's gaps against ``ref`` (a :class:`reference.Reference`):
    at every position, how far the logit of the program's choice lies
    below the reference's best (see :func:`_stats`)."""
    tokens, starts, rows, choices = job_inputs(job, device)
    out = ref.run(tokens, starts, rows, choices)
    return _stats((out["max"] - out["at_choice"]).float(),
                  job.prompts.shape[1])


def control_gaps(ref, control, job, device) -> Dict[str, float]:
    """The gaps of ``control`` (the reference at a lower precision) put
    in the program's place: at each position the token it puts first,
    held against ``ref``'s logits."""
    tokens, starts, rows, _ = job_inputs(job, device)
    first = control.run(tokens, starts, rows)["argmax"]
    out = ref.run(tokens, starts, rows, first)
    return _stats((out["max"] - out["at_choice"]).float(),
                  job.prompts.shape[1])


def combine(readings: List[Dict[str, float]]) -> Dict[str, float]:
    """One reading of several jobs': widest gaps the widest, means and
    shares weighted by positions, positions summed."""
    out: Dict[str, float] = {}
    for part in ("prefill", "decode"):
        n = sum(r[f"positions.{part}"] for r in readings)
        out[f"positions.{part}"] = n
        out[f"gap_max.{part}"] = max(r[f"gap_max.{part}"] for r in readings)
        for key in ("gap_mean", "mismatch"):
            out[f"{key}.{part}"] = (sum(r[f"{key}.{part}"]
                                        * r[f"positions.{part}"]
                                        for r in readings) / n if n else 0.0)
    return out


def pick_jobs(jobs: Sequence, first_index: int, count: int,
              seed: int) -> List:
    """Up to ``count`` of the jobs from ``first_index`` on that served a
    token: the one that served the most (the first such), and others
    drawn from ``seed``."""
    live = [j for j in jobs if j.index >= first_index and j.n_served]
    if not live:
        return []
    longest = max(live, key=lambda j: (j.n_served, -j.index))
    rest = [j for j in live if j is not longest]
    rng = np.random.default_rng(int(seed) % (1 << 63))
    more = rng.permutation(len(rest))[:max(0, count - 1)]
    return [longest] + [rest[i] for i in sorted(more)]


def judge(readings: Dict[str, float], limits: Dict[str, float]):
    """Each number of ``limits`` beside its limit (``{key: {"value",
    "limit"}}``), and whether there was a reading and every number is
    within its limit."""
    check = {key: {"value": readings.get(key), "limit": limit}
             for key, limit in limits.items()}
    correct = bool(readings) and all(
        c["value"] is not None and c["value"] <= c["limit"]
        for c in check.values())
    return check, correct
