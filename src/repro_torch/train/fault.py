"""Fault tolerance: retrying step runner, straggler watch, elastic re-mesh.

The port's copy of ``repro.train.fault``: a step ends on the host when
its loss is read (``float(m["loss"])`` waits for the card, where the
reference calls ``jax.block_until_ready``), and :func:`elastic_remesh`
returns the port's :class:`~repro_torch.launch.mesh.Mesh`.

Designed for the 512-chip (and beyond) deployment where per-step failure
is routine:

* **RetryingRunner** — runs steps with checkpoint/restart semantics:
  any exception (device loss, preemption, numerical trap) triggers a
  restore from the last published checkpoint and replay; the
  deterministic data pipeline makes replay bit-identical.
* **StragglerWatch** — per-host heartbeat ages + per-step wall-time EMA;
  a step slower than ``k x EMA`` marks the slowest host suspect. On TPU
  pods real detection uses the runtime's barrier timings; the interface
  here is transport-agnostic and unit-tested with simulated heartbeats.
  Straggler and dead-host events land on ``train.straggler.*`` obs
  counters so they show up in the same metrics dump as the serve-side
  fault counters.

Retry bookkeeping (attempt counting, backoff, ``*.retries`` /
``*.exhausted`` counters) is delegated to the shared
:class:`repro_torch.faults.policy.RetryPolicy` — the same policy object the
resident executor's replay loop and the serve batcher's restart path
use, so every retry in the system is bounded and counted the same way.
* **elastic_remesh** — on a shrunk/grown device set, rebuild the mesh
  with the survivors (largest (data, model) factorization that preserves
  the model-parallel degree if possible), then re-lower the step and
  restore the mesh-agnostic checkpoint onto the new topology. Given the
  surviving ``torch.distributed`` ranks it makes their process groups
  (only the survivors take part).

On a mesh of ranks the runner checkpoints and restores sharded (its
``mesh`` and ``specs``). On gloo it arms a
:class:`repro_torch.dist.Fence` for the run. A rank that fails,
anywhere in a phase of a step (between two
collectives of the forward or the backward too), posts the fault in the
rendezvous store; every other rank, blocked in a collective or at the
check after the phase, sees it within a poll and fails too. Then every
rank arrives at a rendezvous in the store, the mesh's process groups
are made anew in place (:func:`repro_torch.dist.rebuild_mesh_comm`),
and all restore the same step: the one the mesh's first rank finds
newest. A rank whose process is gone stops its heartbeats: the others
raise :class:`repro_torch.dist.RanksLost` naming it once its heartbeat
is :data:`LOST_AFTER_S` old, and the checkpoints stay as they were, for
:func:`elastic_remesh` and a restore on the survivors.

On any other backend (NCCL) no fence is armed: the ranks agree after
each phase of a step whether any of them failed, so a fault raised
before or after a step's collectives restores every rank, but a rank
that fails between two collectives leaves the others waiting in one
until the group's timeout ends the run. Leaving an NCCL collective
pending needs its communicator aborted, which is not tested here.
"""
from __future__ import annotations

import logging
import time
import traceback
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

from repro_torch import dist, obs
from repro_torch.faults.policy import RetryPolicy
from repro_torch.launch.mesh import Mesh, mesh_over_ranks

from .checkpoint import latest_step, restore_checkpoint, save_checkpoint

logger = logging.getLogger("repro_torch.fault")

__all__ = ["StragglerWatch", "RetryingRunner", "elastic_remesh",
           "choose_mesh_shape", "RanksLost"]

RanksLost = dist.RanksLost

# After a fault, a rank of the mesh that has not arrived and whose
# heartbeat (every 0.5 s, dist.Fence) is this old is lost; one that
# still beats is waited for up to the process group's timeout.
LOST_AFTER_S = 10.0


class StragglerWatch:
    """Step-time EMA + host heartbeats -> suspect set."""

    def __init__(self, slow_factor: float = 2.5, ema: float = 0.9,
                 heartbeat_timeout_s: float = 60.0):
        self.slow_factor = slow_factor
        self.ema_coef = ema
        self.timeout = heartbeat_timeout_s
        self.ema: Optional[float] = None
        self.heartbeats: Dict[int, float] = {}
        self.suspects: Dict[int, int] = {}

    def heartbeat(self, host: int, t: Optional[float] = None) -> None:
        """Record a heartbeat of ``host`` at ``t`` (default now)."""
        self.heartbeats[host] = time.monotonic() if t is None else t

    def observe_step(self, wall_s: float,
                     slowest_host: Optional[int] = None) -> bool:
        """Returns True if this step is a straggler event."""
        if self.ema is None:
            self.ema = wall_s
            return False
        slow = wall_s > self.slow_factor * self.ema
        # stragglers should not poison the baseline
        if not slow:
            self.ema = self.ema_coef * self.ema + (1 - self.ema_coef) * wall_s
        if slow:
            obs.counter("train.straggler.events").inc()
            obs.instant("train.straggler", wall_s=wall_s, ema_s=self.ema,
                        host=slowest_host)
            if slowest_host is not None:
                self.suspects[slowest_host] = self.suspects.get(
                    slowest_host, 0) + 1
        return slow

    def dead_hosts(self, now: Optional[float] = None) -> List[int]:
        """Hosts whose last heartbeat is older than the timeout."""
        now = time.monotonic() if now is None else now
        dead = [h for h, t in self.heartbeats.items()
                if now - t > self.timeout]
        obs.gauge("train.straggler.dead_hosts").set(len(dead))
        return dead

    def evict_candidates(self, strikes: int = 3) -> List[int]:
        """Hosts named slowest in at least ``strikes`` straggler steps."""
        return [h for h, n in self.suspects.items() if n >= strikes]


def choose_mesh_shape(n_devices: int, model_parallel: int
                      ) -> Tuple[int, int]:
    """Largest (data, model) grid from the survivors, keeping TP degree
    if divisible, else the largest power-of-two TP that fits."""
    tp = model_parallel
    while tp > 1 and n_devices % tp != 0:
        tp //= 2
    return n_devices // tp, tp


def elastic_remesh(devices, model_parallel: int) -> Mesh:
    """A (data, model) :class:`Mesh` over the surviving ``devices``
    (shape from :func:`choose_mesh_shape`). Under a running process
    group, ``devices`` are the surviving global ranks: each survivor
    calls this, and gets the mesh with its process groups."""
    dp, tp = choose_mesh_shape(len(devices), model_parallel)
    devices = list(devices)
    if dist.is_initialized() and all(isinstance(d, int) for d in devices):
        if dist.rank() not in devices:
            raise ValueError(f"rank {dist.rank()} is not a survivor "
                             f"{devices}")
        return mesh_over_ranks((dp, tp), ("data", "model"), devices,
                               local_sync=True)
    grid = tuple(tuple(devices[i * tp:(i + 1) * tp]) for i in range(dp))
    return Mesh((dp, tp), ("data", "model"), grid)


def _attempt(fn: Callable[[], None]) -> Optional[Exception]:
    """``fn()``'s exception, or None."""
    try:
        fn()
    except Exception as e:   # noqa: BLE001 — any fault retries
        return e
    return None


@dataclass
class RetryingRunner:
    """Checkpointed, retrying training loop.

    Retry accounting runs through the shared
    :class:`repro_torch.faults.policy.RetryPolicy` (``policy``); the legacy
    ``max_retries`` knob builds a default zero-backoff policy when no
    explicit one is given, preserving the original semantics: up to
    ``max_retries`` *consecutive* failures are retried (the counter
    resets on every successful step), the next one propagates.
    """

    step_fn: Callable[..., Tuple]         # (params, opt, resid, batch) -> ...
    batch_fn: Callable[[int], Any]        # step -> device-ready batch
    ckpt_dir: str
    ckpt_every: int = 100
    max_retries: int = 3
    watch: StragglerWatch = field(default_factory=StragglerWatch)
    on_failure: Optional[Callable[[Exception, int], None]] = None
    policy: Optional[RetryPolicy] = None
    mesh: Any = None        # a mesh of ranks: checkpoints sharded by specs
    specs: Any = None       # of {"params": ..., "opt": ...}

    def __post_init__(self):
        if self.policy is None:
            self.policy = RetryPolicy(max_retries=self.max_retries,
                                      scope="train.retry")

    def _comm(self):
        """This rank's :class:`repro_torch.dist.MeshComm` (None: one
        process)."""
        comm = getattr(self.mesh, "comm", None)
        return None if comm is None or len(comm.ranks) < 2 else comm

    def _group(self):
        """The process group over every rank of the mesh (None: one
        process)."""
        comm = self._comm()
        return None if comm is None else comm.axis(comm.axis_names).group

    def latest(self) -> Optional[int]:
        """The newest step, as the mesh's first rank finds it."""
        last = latest_step(self.ckpt_dir)
        group = self._group()
        if group is None:
            return last
        last = dist.broadcast_int(-1 if last is None else last, group)
        return None if last < 0 else last

    def _agree(self, err: Optional[Exception], step: int, fenced: bool
               ) -> Optional[Exception]:
        """``err``, or, when this rank went through the phase, an error
        for the fault of another rank that did not; None when every rank
        went through. Every rank calls it at the end of each phase.
        Under the fence a rank that failed is never waited for: the
        others meet at a barrier, which the posted fault breaks. Without
        it the ranks gather who failed, so all of them restore
        together."""
        group = self._group()
        if group is None:
            return err
        if fenced:
            return err if err is not None else _attempt(
                lambda: dist.barrier(group))
        failed = dist.all_gather_ints(int(err is not None), group)
        if err is None and any(failed):
            ranks = [r for r, f in enumerate(failed) if f]
            err = RuntimeError(f"step {step} failed on mesh rank(s) "
                               f"{ranks}")
        return err

    def _recover(self, fence, err: Exception, step: int) -> None:
        """After a fault on the mesh: post it (unless it is another
        rank's), wait for every rank in the store, and make the mesh's
        groups anew. Raises :class:`RanksLost` naming the ranks whose
        heartbeat is :data:`LOST_AFTER_S` old, and ``TimeoutError`` when
        live ranks have not come within the group's timeout."""
        if not isinstance(err, dist.PeerFault):
            fence.post(f"rank {fence.rank} at step {step}: "
                       f"{type(err).__name__}: {err}")
        fence.arrive()
        watch = StragglerWatch(heartbeat_timeout_s=LOST_AFTER_S)
        seen: Dict[int, int] = {}
        t_end = time.monotonic() + dist.DEFAULT_TIMEOUT_S
        while True:
            missing = fence.missing()
            if not missing:
                break
            now = time.monotonic()
            for r in missing:
                beats = fence.beats(r)
                if seen.get(r) != beats:
                    seen[r] = beats
                    watch.heartbeat(r, now)
            lost = [r for r in watch.dead_hosts(now) if r in missing]
            if lost:
                raise RanksLost(lost, f"mesh rank(s) {sorted(lost)} lost: "
                                f"no heartbeat for {LOST_AFTER_S} s "
                                f"after the fault at step {step} ({err})")
            if now > t_end:
                raise TimeoutError(f"mesh rank(s) {missing} did not come "
                                   f"to recover step {step} within "
                                   f"{dist.DEFAULT_TIMEOUT_S} s")
            time.sleep(fence.poll_s / 2)
        fence.next_generation()
        dist.rebuild_mesh_comm(self._comm())

    def run(self, state: Tuple, start_step: int, num_steps: int,
            inject_failure: Optional[Callable[[int], None]] = None
            ) -> Tuple[Tuple, Dict]:
        """state = (params, opt_state, residual). Returns final state and
        run metrics. ``inject_failure`` is the test hook.

        On a mesh of ranks a fault that any rank raises in any phase of a
        step (taking the batch, the step itself between or inside its
        collectives, the checkpoint) restores and replays on every rank
        (see the module docstring: on gloo only, inside the step);
        ``metrics["recovery_s"]`` holds each recovery's seconds on this
        rank, from the fault to the restored state. A lost rank raises
        :class:`RanksLost` on the others."""
        comm = self._comm()
        if comm is None or not dist.Fence.supported(self._group()):
            return self._run(None, state, start_step, num_steps,
                             inject_failure)
        with dist.Fence(comm.ranks) as fence:
            return self._run(fence, state, start_step, num_steps,
                             inject_failure)

    def _run(self, fence, state, start_step, num_steps, inject_failure):
        params, opt_state, residual = state
        step = start_step
        retries = 0
        metrics: Dict[str, Any] = {"straggler_events": 0, "restarts": 0,
                                   "recovery_s": []}
        fenced = fence is not None
        while step < start_step + num_steps:
            out: Dict[str, Any] = {}

            def take_batch():
                if inject_failure is not None:
                    inject_failure(step)
                out["t0"] = time.monotonic()
                out["batch"] = self.batch_fn(step)

            def take_step():
                out["state"] = self.step_fn(params, opt_state, residual,
                                            out.pop("batch"))
                out["loss"] = float(out["state"][3]["loss"])  # waits
                out["wall"] = time.monotonic() - out["t0"]

            err = self._agree(_attempt(take_batch), step, fenced)
            if err is None:
                err = self._agree(_attempt(take_step), step, fenced)
            if err is None:
                params, opt_state, residual, _ = out.pop("state")
                if self.watch.observe_step(out["wall"]):
                    metrics["straggler_events"] += 1
                    logger.warning("straggler step %d: %.2fs", step,
                                   out["wall"])
                metrics["loss"] = out["loss"]
                step += 1
                retries = 0
                if step % self.ckpt_every == 0:
                    err = self._agree(_attempt(lambda: save_checkpoint(
                        self.ckpt_dir, step,
                        {"params": params, "opt": opt_state},
                        mesh=self.mesh, specs=self.specs)), step, fenced)
            if err is None:
                continue
            t_fault = time.monotonic()
            out.clear()
            if err.__traceback__ is not None:    # the failed step's tensors
                traceback.clear_frames(err.__traceback__)
            if fence is not None:
                self._recover(fence, err, step)
            retries += 1
            metrics["restarts"] += 1
            if self.on_failure:
                self.on_failure(err, step)
            if retries > self.policy.max_retries:
                self.policy.note_exhausted()
                raise err
            self.policy.note_retry(retries - 1)
            logger.warning("step %d failed (%s); restoring", step, err)
            last = self.latest()
            if last is not None:
                restored, _ = restore_checkpoint(
                    self.ckpt_dir, {"params": params, "opt": opt_state},
                    step=last, mesh=self.mesh, specs=self.specs)
                params, opt_state = restored["params"], restored["opt"]
                step = last
            metrics["recovery_s"].append(time.monotonic() - t_fault)
        return (params, opt_state, residual), metrics
