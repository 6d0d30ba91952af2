"""A closed loop of batch jobs through the port's model-serving entries.

A job is one static batch, as ``repro_torch.launch.serve.serve_model``
serves it: ``batch`` prompts of ``prompt_len`` tokens prefilled through
``model.forward`` with fresh decode states, then greedy decode steps
through ``repro_torch.train.make_serve_step``'s step, one call a step,
until every sequence has ``gen`` tokens. Each call ends in a host copy
of its tokens, which waits for the card. The client submits its next job
when the last returns (offline batched generation).

The loop calls those entries itself, in ``serve_model``'s order, so that
a window can open after a job's prefill and close between two steps. The
one thing it adds to ``serve_model``'s prefill is the greedy choice at
every prompt position (an argmax of the logits the prefill made anyway),
kept on the card for the comparison with the reference.

A window times one phase. With whole jobs as its unit it holds every
call. With decode steps as its unit, a new job's prefill still runs
through the same path when the last job is done, and its tokens are
served and can be compared, but it is kept off the window: not among
its steps, its seconds not on its clock, and its memory not in its peak.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

__all__ = ["Step", "Job", "Window", "Server"]


@dataclass
class Step:
    """One call of the served program: a job's prefill or a decode step.
    ``t0``/``t1`` on the host clock, ``t1`` after its tokens reached the
    host. ``attended``: the attended positions summed over its tokens;
    ``cpu_s``: the main thread's CPU time over the call."""

    kind: str
    job: int
    t0: float
    t1: float
    gen_tokens: int
    prompt_tokens: int
    attended: int
    cpu_s: float = 0.0

    @property
    def seconds(self) -> float:
        return self.t1 - self.t0


@dataclass
class Job:
    """One static batch: its prompts, the tokens served so far, and the
    program's greedy choice at every prompt position."""

    index: int
    prompts: torch.Tensor
    submit: float
    first_token: Optional[float] = None
    done: Optional[float] = None
    served: List[np.ndarray] = field(default_factory=list)
    prefill_choice: Optional[torch.Tensor] = None
    states: object = None
    tok: Optional[torch.Tensor] = None

    @property
    def n_served(self) -> int:
        return len(self.served)

    def tokens(self) -> np.ndarray:
        """(B, n_served) int32: the prefill's token, then a step's each."""
        return np.concatenate(self.served, axis=1)


@dataclass
class Window:
    """What :meth:`Server.run` timed. ``steps``: the calls on the window's
    clock; ``seconds``: that clock, the host clock from the window's start
    to its last step's end less every call kept off it (the steps'
    seconds and the loop's few microseconds between them);
    ``kept_off``: the prefills kept off it; ``peak_bytes``: the
    card's peak allocated memory over the window's steps (0 off a card);
    ``kept_off_peak_bytes``: that over the prefills kept off."""

    steps: List[Step]
    seconds: float
    kept_off: List[Step] = field(default_factory=list)
    peak_bytes: int = 0
    kept_off_peak_bytes: int = 0


class Server:
    """Serves jobs of ``traffic``'s shape one after another on ``model``
    with ``params``, prompts from ``prompts`` (a
    :class:`pimbench.weights.PromptStream`)."""

    def __init__(self, model, params, traffic, prompts):
        from repro_torch.train.step import greedy_token, make_serve_step
        self.model = model
        self.params = params
        self.batch = int(traffic["batch"])
        self.prompt_len = int(traffic["prompt_len"])
        self.gen = int(traffic["gen"])
        self.cache_len = int(traffic["cache_len"])
        if self.prompt_len + self.gen - 1 > self.cache_len:
            raise ValueError("a job's tokens do not fit its cache_len")
        self.prompts = prompts
        self.step_fn = make_serve_step(model)[0]
        self.greedy_token = greedy_token
        self.jobs: List[Job] = []
        self.clock = time.perf_counter
        self.cuda = torch.device(prompts.device).type == "cuda"

    @property
    def current(self) -> Optional[Job]:
        return self.jobs[-1] if self.jobs else None

    def job_done(self) -> bool:
        """Whether the newest job has all its tokens (or there is none)."""
        job = self.current
        return job is None or job.n_served >= self.gen

    def advance(self) -> Step:
        """The next call: a new job's prefill when the last job is done,
        else the current job's next decode step."""
        c0 = time.thread_time()
        step = self._prefill() if self.job_done() else self._decode()
        step.cpu_s = time.thread_time() - c0
        return step

    def _prefill(self) -> Step:
        if self.current is not None:
            self.current.states = None       # the last job's caches go
            self.current.tok = None
        t0 = self.clock()
        job = Job(len(self.jobs), self.prompts.next(), t0)
        self.jobs.append(job)
        b, s = job.prompts.shape
        states = self.model.init_decode_state(b, self.cache_len)
        logits, states = self.model.forward(self.params, job.prompts,
                                            states=states)
        job.prefill_choice = torch.argmax(logits, dim=-1)
        tok = self.greedy_token(self.model.cfg, logits)
        del logits
        job.served.append(tok.cpu().numpy())       # waits for the card
        t1 = self.clock()
        job.first_token = t1
        job.states, job.tok = states, tok
        if job.n_served >= self.gen:
            job.done = t1
        return Step("prefill", job.index, t0, t1, b, b * s,
                    b * s * (s + 1) // 2)

    def _decode(self) -> Step:
        job = self.current
        t0 = self.clock()
        b, s = job.prompts.shape
        p = s + job.n_served - 1
        pos = torch.full((b, 1), p, dtype=torch.int32,
                         device=job.prompts.device)
        job.tok, job.states = self.step_fn(self.params, job.states, job.tok,
                                           pos)
        job.served.append(job.tok.cpu().numpy())   # waits for the card
        t1 = self.clock()
        if job.n_served >= self.gen:
            job.done = t1
        return Step("decode", job.index, t0, t1, b, 0, b * (p + 1))

    def warm_up(self, unit: str) -> int:
        """Set-up's calls: the first job's prefill and, where the job has
        decode steps, one of them, which warm both shapes; with whole jobs
        as the ``unit``, the rest of that job. Returns the index of the
        first job a window then serves whole (0 when the window goes on
        with the first)."""
        self.advance()
        if not self.job_done():
            self.advance()
        while unit == "job" and not self.job_done():
            self.advance()
        return len(self.jobs) if unit == "job" else 0

    def make_room(self, steps: int) -> None:
        """Calls off any window until the newest job has at least
        ``steps`` decode steps left (at most a job's): where it has
        fewer, the rest of it and the next job's prefill."""
        left = 0 if self.job_done() else self.gen - self.current.n_served
        if left >= min(steps, self.gen - 1):
            return
        while not self.job_done():
            self.advance()
        self.advance()

    def _peak(self) -> int:
        return torch.cuda.max_memory_allocated() if self.cuda else 0

    def run(self, seconds: float, unit: str, *,
            new_jobs: bool = True) -> Window:
        """Calls until the window's clock reads ``seconds``, then on to
        the end of the step (``unit`` ``"step"``) or of the job
        (``"job"``) in progress. With ``"step"``, a new job's prefill is
        kept off the window (the module docstring), or, without
        ``new_jobs``, the window ends at the newest job's end instead."""
        if unit not in ("step", "job"):
            raise ValueError(f"window unit {unit!r}")
        win = Window([], 0.0)
        t0 = self.clock()
        off = 0.0
        while True:
            if unit == "step" and self.job_done():
                if not new_jobs:
                    break
                win.peak_bytes = max(win.peak_bytes, self._peak())
                a = self.clock()
                win.kept_off.append(self.advance())
                off += self.clock() - a
                win.kept_off_peak_bytes = max(win.kept_off_peak_bytes,
                                              self._peak())
                if self.cuda:
                    torch.cuda.reset_peak_memory_stats()
                continue
            win.steps.append(self.advance())
            if self.clock() - t0 - off >= seconds and (unit == "step"
                                                       or self.job_done()):
                break
        win.seconds = (win.steps[-1].t1 - t0 - off) if win.steps else 0.0
        win.peak_bytes = max(win.peak_bytes, self._peak())
        return win

    def release(self) -> None:
        """Drop the program's state (the caches and the last token)."""
        for job in self.jobs:
            job.states = None
            job.tok = None
