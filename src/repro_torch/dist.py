"""Process groups and collectives for the port's sharded runs.

What ``jax.make_mesh`` and GSPMD give the reference, made explicit: one
process a rank, the ranks of a mesh laid out row-major over its axes (as
``jax.make_mesh`` lays out devices), one process group for every set of
mesh axes, and collectives called by hand where GSPMD would insert them.

* :func:`init_distributed` starts the process group from the standard
  ``RANK``/``WORLD_SIZE``/``MASTER_ADDR``/``MASTER_PORT`` environment
  (``python -m torch.distributed.run``), or from a ``FileStore`` (tests).
  The caller names the backend, and nothing here switches it: ``nccl``
  when every rank has a card of its own, ``gloo`` on the CPU and when
  ranks share one card. The group has a timeout, so one rank's exception
  ends the run with an error rather than a hang.
* :class:`MeshComm` is one rank's view of a mesh: its coordinates and a
  :class:`ParallelAxis` (group, size, this rank's index) for every set of
  axes. :func:`build_mesh_comm` makes the groups.
* :func:`mesh_axis` gives this rank's place on a set of a mesh's axes;
  the model code takes the mesh it shards over as an argument.
* The collectives: :func:`all_reduce`, :func:`all_reduce_max`,
  :func:`all_gather` and :func:`reduce_scatter` (along any dimension),
  :func:`broadcast`, and the autograd-aware forms of Megatron's layout,
  which is what GSPMD inserts for the partition rules:
  :func:`copy_to_parallel` (identity forward, all-reduce backward: into
  a column-parallel region), :func:`reduce_from_parallel` (all-reduce
  forward, identity backward: out of a row-parallel one),
  :func:`gather_from_parallel` (all-gather forward, reduce-scatter
  backward: a sharded leaf made whole inside a parallel region),
  :func:`gather_out_of_parallel` (all-gather forward, this rank's slice
  backward: a column-parallel result made whole for the replicated
  stream), :func:`sum_in_parallel` (all-reduce forward and backward: a
  partial sum that each rank then uses on its own slice, as a norm over
  a split dimension), and :func:`max_from_parallel` (a quantisation
  scale's maximum over the ranks that split its tensor, with the
  maximum's gradient). A collective over a ``None`` group (an axis of
  size 1) is the identity.
* :func:`collective_bytes` counts what the collectives above have
  moved since :func:`reset_collective_bytes`: the bytes of each call's
  output under the reference's HLO name (``all-reduce``: the tensor;
  ``all-gather``: the gathered tensor; ``reduce-scatter``: this rank's
  part; a broadcast, which the reference's steps do not have, under its
  ``c10d`` name ``broadcast_``). Under an armed :class:`Fence` a
  reduce-scatter runs, and counts, as the all-reduce of the whole.
* :func:`fake_world` runs one rank of a world of any size in this
  process on torch's fake backend, which completes every collective
  without moving a byte: the dry-run traces a rank's real sharded step
  under it, on fake tensors.
* :class:`Fence` carries a fault out of band, through the rendezvous
  store (a ``FileStore``, or the ``TCPStore`` of
  ``torch.distributed.run``), which outlives a broken collective. While
  a fence is armed every collective above is issued asynchronously and
  waited for in short polls; between polls the rank looks for a fault
  that another rank of the mesh posted and raises :class:`PeerFault`,
  so no rank stays blocked in a collective that a failed rank will never
  enter. A rank whose process died closes its sockets, so a rank that
  waits on it gets gloo's error at once and posts it in turn.
  :func:`rebuild_mesh_comm` then makes a mesh's process groups anew, in
  place, so every :class:`ParallelAxis` that a step holds sees them.
  The retrying runner (:mod:`repro_torch.train.fault`) arms it on gloo
  alone (:meth:`Fence.supported`): an NCCL collective left pending
  needs its communicator aborted, which is not tested here.

Gloo takes CUDA tensors for every collective used here in the torch of
the card's machine (2.11; :func:`probe_gloo_cuda`, ``python -m
repro_torch.dist``), so nothing is staged by hand; gloo itself moves
every byte through host memory and the loopback, so a gloo step's time
is not a multi-card time. Under tracing (:mod:`repro_torch.obs`) each
collective's call is a span ``dist.<collective>`` (``bytes``: the
tensor's): host seconds inside the call, which for a CUDA tensor under
gloo include waiting for the card's queue and for the other ranks.

Imports no JAX and nothing of the reference package.
"""
from __future__ import annotations

import contextlib
import datetime
import itertools
import math
import os
import threading
import time
from dataclasses import dataclass
from typing import (Any, Dict, FrozenSet, Iterable, List, Optional, Sequence,
                    Tuple)

import torch
import torch.distributed as dist

from repro_torch import obs

__all__ = ["DEFAULT_TIMEOUT_S", "COLLECTIVES", "init_distributed",
           "is_initialized", "world_size", "rank", "local_rank",
           "local_device", "ParallelAxis", "MeshComm", "build_mesh_comm",
           "mesh_axis", "all_reduce",
           "all_reduce_by_axes", "all_reduce_max", "all_gather",
           "reduce_scatter", "broadcast", "broadcast_int", "all_gather_ints",
           "barrier", "copy_to_parallel", "reduce_from_parallel",
           "gather_from_parallel", "gather_out_of_parallel",
           "sum_in_parallel", "max_from_parallel", "collective_bytes",
           "reset_collective_bytes", "fake_world", "rebuild_mesh_comm",
           "Fence", "PeerFault", "RanksLost"]

DEFAULT_TIMEOUT_S = 300.0

# The collectives this module calls, with the dtypes the port gives
# them (float32 unless named); gloo must take CUDA tensors for each
# (:func:`probe_gloo_cuda`).
COLLECTIVES = ("all_reduce", "all_reduce_int64", "all_reduce_max",
               "broadcast", "all_gather", "all_gather_int32",
               "all_gather_float64", "reduce_scatter", "barrier")

# The single-tensor all-gather and reduce-scatter: torch 2.13's names,
# or the earlier ``*_tensor`` ones where a torch has only those (2.13
# warns that they are deprecated).
_all_gather_single = getattr(dist, "all_gather_single", None) or getattr(
    dist, "all_gather_into_tensor", None)
_reduce_scatter_single = getattr(dist, "reduce_scatter_single", None) or \
    getattr(dist, "reduce_scatter_tensor", None)


# ------------------------------------------------------------- set-up ----
def init_distributed(backend: str, *, rank: Optional[int] = None,
                     world_size: Optional[int] = None,
                     store_path: Optional[str] = None,
                     timeout_s: float = DEFAULT_TIMEOUT_S) -> int:
    """Start the default process group with ``backend`` (``"nccl"`` or
    ``"gloo"``) and return this process's rank.

    With ``store_path`` the ranks meet in a ``FileStore`` there (``rank``
    and ``world_size`` given); otherwise the environment that
    ``torch.distributed.run`` sets names them. Raises if a group is
    already running, if the backend is neither, or if ``nccl`` is asked
    for without CUDA."""
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend {backend!r}: 'nccl' or 'gloo'")
    if dist.is_initialized():
        raise RuntimeError("a torch.distributed process group is already "
                           "running in this process")
    if backend == "nccl" and not torch.cuda.is_available():
        raise RuntimeError("the nccl backend needs CUDA; use gloo on the "
                           "CPU")
    timeout = datetime.timedelta(seconds=timeout_s)
    if store_path is not None:
        if rank is None or world_size is None:
            raise ValueError("a FileStore needs rank and world_size")
        store = dist.FileStore(store_path, world_size)
        dist.init_process_group(backend, store=store, rank=rank,
                                world_size=world_size, timeout=timeout)
    else:
        missing = [k for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR",
                               "MASTER_PORT") if k not in os.environ]
        if missing:
            raise RuntimeError(f"no {', '.join(missing)} in the "
                               f"environment: run under python -m "
                               f"torch.distributed.run")
        dist.init_process_group(backend, init_method="env://",
                                timeout=timeout)
    if backend == "nccl":
        torch.cuda.set_device(local_device("cuda"))
    return dist.get_rank()


@contextlib.contextmanager
def fake_world(axis_sizes: Sequence[int], rank: int = 0):
    """Run rank ``rank`` of a world of ``prod(axis_sizes)`` ranks in this
    process, on torch's fake backend (``fake_pg``): the default group and
    every group made inside complete their collectives at once and move
    nothing, so a rank's sharded step runs on fake tensors
    (``FakeTensorMode``) as it would on its own card. Yields the world
    size; the group ends on exit.

    Raises if a process group is already running in this process (one
    process has one default group) or if this torch has no fake
    backend."""
    if is_initialized():
        raise RuntimeError("a torch.distributed process group is already "
                           "running in this process; the fake world needs "
                           "a process of its own")
    try:
        from torch.testing._internal.distributed.fake_pg import FakeStore
    except ImportError as e:
        raise RuntimeError(f"this torch ({torch.__version__}) has no fake "
                           f"process-group backend: {e}") from None
    n = math.prod(int(a) for a in axis_sizes)
    if not 0 <= rank < n:
        raise ValueError(f"rank {rank} of a world of {n}")
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=n)
    try:
        yield n
    finally:
        dist.destroy_process_group()


def is_initialized() -> bool:
    """True when a default process group is running."""
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    """Ranks of the default group (1 without one)."""
    return dist.get_world_size() if is_initialized() else 1


def rank() -> int:
    """This process's rank (0 without a group)."""
    return dist.get_rank() if is_initialized() else 0


def local_rank() -> int:
    """``LOCAL_RANK`` from the environment, else the rank (one host)."""
    return int(os.environ.get("LOCAL_RANK", rank()))


def local_device(kind: str) -> torch.device:
    """This rank's device of ``kind``: ``cuda:LOCAL_RANK % device_count``
    (ranks share the cards round-robin, all of them ``cuda:0`` on one
    card), or the CPU."""
    if kind == "cpu":
        return torch.device("cpu")
    if kind != "cuda":
        raise ValueError(f"device kind {kind!r}")
    return torch.device("cuda", local_rank() % torch.cuda.device_count())


# --------------------------------------------------------------- mesh ----
@dataclass(eq=False)
class ParallelAxis:
    """One rank's place on a set of mesh axes: the process group over
    them (``None`` when they hold one rank), their size and this rank's
    index (row-major over the axes, which is its rank in the group).
    :func:`rebuild_mesh_comm` replaces ``group`` in place, so a step that
    took the axis when it was made goes on with the new group."""

    group: Any
    size: int
    index: int


@dataclass(frozen=True, eq=False)
class MeshComm:
    """This rank's view of a mesh: its global ``rank``, its ``coords``
    over ``axis_names``, a :class:`ParallelAxis` for every non-empty set
    of axes (``axes``, keyed by frozenset of names), the mesh's global
    ``ranks`` (row-major) and whether its groups were made by its own
    ranks alone (``local_sync``)."""

    rank: int
    axis_names: Tuple[str, ...]
    axis_sizes: Tuple[int, ...]
    coords: Tuple[int, ...]
    axes: Dict[FrozenSet[str], ParallelAxis]
    ranks: Tuple[int, ...] = ()
    local_sync: bool = False

    def axis(self, names: Iterable[str]) -> ParallelAxis:
        """The :class:`ParallelAxis` over ``names`` (names not on the
        mesh are ignored; none left is a size-1 axis)."""
        key = frozenset(n for n in names if n in self.axis_names)
        if not key:
            return ParallelAxis(None, 1, 0)
        return self.axes[key]


def _row_major(sizes: Sequence[int], coords: Sequence[int]) -> int:
    idx = 0
    for n, c in zip(sizes, coords):
        idx = idx * n + c
    return idx


def _mesh_groups(axis_sizes: Tuple[int, ...], ranks: List[int],
                 coords: Optional[Tuple[int, ...]]):
    """Every process group of a mesh, in the order every rank makes them:
    ``(axis indices, size, sorted members, mine, this rank's index)``
    (``mine`` false and the index None on a rank outside the group)."""
    n_axes = len(axis_sizes)
    for mask in range(1, 1 << n_axes):
        sub = [i for i in range(n_axes) if mask >> i & 1]
        rest = [i for i in range(n_axes) if not mask >> i & 1]
        size = math.prod(axis_sizes[i] for i in sub)
        for fixed in itertools.product(*(range(axis_sizes[i])
                                         for i in rest)):
            members = []
            for inner in itertools.product(*(range(axis_sizes[i])
                                             for i in sub)):
                c = [0] * n_axes
                for i, v in zip(rest, fixed):
                    c[i] = v
                for i, v in zip(sub, inner):
                    c[i] = v
                members.append(ranks[_row_major(axis_sizes, c)])
            mine = coords is not None and all(
                coords[i] == v for i, v in zip(rest, fixed))
            index = (_row_major([axis_sizes[i] for i in sub],
                                [coords[i] for i in sub]) if mine else None)
            yield sub, size, sorted(members), mine, index


def build_mesh_comm(axis_sizes: Sequence[int], axis_names: Sequence[str],
                    ranks: Sequence[int], *, local_sync: bool = False
                    ) -> Optional[MeshComm]:
    """Make the process groups of a mesh over ``ranks`` (global ranks,
    row-major over the axes) and return this rank's :class:`MeshComm`,
    or None when this rank is not on the mesh.

    Every rank of the default group must call this with the same
    arguments, in the same order with the other group-making calls,
    unless ``local_sync``: then only the mesh's ranks call it (the
    survivors of an elastic re-mesh)."""
    axis_sizes = tuple(int(n) for n in axis_sizes)
    axis_names = tuple(axis_names)
    ranks = [int(r) for r in ranks]
    if len(ranks) != math.prod(axis_sizes):
        raise ValueError(f"{len(ranks)} ranks for a mesh of {axis_sizes}")
    me = dist.get_rank()
    coords = None
    if me in ranks:
        flat = ranks.index(me)
        coords = []
        for n in reversed(axis_sizes):
            coords.append(flat % n)
            flat //= n
        coords = tuple(reversed(coords))
    axes: Dict[FrozenSet[str], ParallelAxis] = {}
    for sub, size, members, mine, index in _mesh_groups(axis_sizes, ranks,
                                                        coords):
        group = None
        if size > 1 and (mine or not local_sync):
            group = dist.new_group(members,
                                   use_local_synchronization=local_sync)
        if mine:
            axes[frozenset(axis_names[i] for i in sub)] = ParallelAxis(
                group, size, index)
    if coords is None:
        return None
    return MeshComm(me, axis_names, axis_sizes, coords, axes, tuple(ranks),
                    local_sync)


def rebuild_mesh_comm(comm: MeshComm) -> None:
    """Make every process group of ``comm``'s mesh anew and put each in
    its :class:`ParallelAxis` in place (after a fault has left the old
    ones with collectives that will never finish; those are abandoned,
    not destroyed, so no group name is used twice). Called as the mesh
    was made: by every rank of the default group in the same order
    (which then must all be on the mesh), or, for a mesh made with
    ``local_sync``, by its own ranks."""
    if not comm.local_sync and len(comm.ranks) != world_size():
        raise RuntimeError(f"a mesh of {len(comm.ranks)} of the world's "
                           f"{world_size()} ranks, made by every rank, "
                           f"cannot be rebuilt by its own ranks alone")
    ranks = list(comm.ranks)
    for sub, size, members, mine, _ in _mesh_groups(comm.axis_sizes, ranks,
                                                    comm.coords):
        if size > 1 and (mine or not comm.local_sync):
            group = dist.new_group(members,
                                   use_local_synchronization=comm.local_sync)
            if mine:
                key = frozenset(comm.axis_names[i] for i in sub)
                comm.axes[key].group = group


def mesh_axis(mesh, names: Iterable[str]) -> ParallelAxis:
    """``mesh``'s :class:`ParallelAxis` over ``names`` for this rank: a
    size-1 axis when ``mesh`` is None or has no process groups (one
    process)."""
    comm = getattr(mesh, "comm", None)
    if comm is None:
        return ParallelAxis(None, 1, 0)
    return comm.axis(names)


# -------------------------------------------------------- fault fence ----
class PeerFault(RuntimeError):
    """Another rank of an armed :class:`Fence`'s mesh posted a fault while
    this rank waited in a collective (the message is what it posted)."""


class RanksLost(RuntimeError):
    """Ranks of a mesh that stopped taking part: their processes are
    gone (``ranks``, global)."""

    def __init__(self, ranks: Sequence[int], message: str):
        super().__init__(message)
        self.ranks = tuple(int(r) for r in ranks)


_FENCE: Optional["Fence"] = None
_FENCE_RUNS: Dict[Tuple[int, ...], int] = {}


def _default_store():
    """The default group's rendezvous store (``torch.distributed`` keeps
    it private): a ``FileStore``, or ``torch.distributed.run``'s
    ``TCPStore`` under this attempt's prefix."""
    from torch.distributed.distributed_c10d import _get_default_store
    return _get_default_store()


class Fence:
    """Out-of-band fault signals among the ``ranks`` of a mesh, through
    the default group's store, which a broken collective leaves
    working. Every rank of the mesh makes its fences in the same order
    (keys are kept apart by the ranks and a count of the fences made
    over them), and arms one with ``with fence:``.

    While armed: a heartbeat thread adds one to this rank's counter
    every ``beat_s``; every collective of this module waits in polls and,
    every ``poll_s``, raises :class:`PeerFault` when a rank
    has :meth:`post`-ed a fault for this ``generation``. After a fault
    each rank :meth:`arrive`-s; :meth:`missing` and :meth:`beats` tell
    the caller who has not come and whether they still beat;
    :meth:`next_generation` starts over."""

    poll_s = 0.2       # seconds between looks for a posted fault
    beat_s = 0.5       # seconds between heartbeats

    @staticmethod
    def supported(group) -> bool:
        """Whether a fence can be armed over ``group``: gloo only, whose
        pending collectives are simply left behind after a fault."""
        return group is not None and dist.get_backend(group) == "gloo"

    def __init__(self, ranks: Sequence[int]):
        self.ranks = tuple(sorted(int(r) for r in ranks))
        self.rank = rank()
        n = _FENCE_RUNS.get(self.ranks, 0)
        _FENCE_RUNS[self.ranks] = n + 1
        mesh = "_".join(map(str, self.ranks))
        self.store = dist.PrefixStore(f"repro_torch/fence/{mesh}/{n}/",
                                      _default_store())
        self.generation = 0
        self._stop = threading.Event()
        self._beater: Optional[threading.Thread] = None

    def __enter__(self) -> "Fence":
        global _FENCE
        if _FENCE is not None:
            raise RuntimeError("a fence is already armed in this process")
        if not Fence.supported(dist.group.WORLD):
            raise RuntimeError(f"a fence needs gloo, not "
                               f"{dist.get_backend()}")
        self.store.add(f"beat/{self.rank}", 1)
        self._stop.clear()
        self._beater = threading.Thread(target=self._beat, daemon=True,
                                        name=f"fence-beat-{self.rank}")
        self._beater.start()
        _FENCE = self
        return self

    def __exit__(self, *exc) -> None:
        global _FENCE
        _FENCE = None
        self._stop.set()
        self._beater.join()

    def _beat(self) -> None:
        while not self._stop.wait(self.beat_s):
            try:
                self.store.add(f"beat/{self.rank}", 1)
            except RuntimeError:    # the store's host is gone: so is the mesh
                return

    def _key(self, what: str) -> str:
        return f"g{self.generation}/{what}"

    def post(self, message: str) -> None:
        """Post a fault of this rank for this generation (the first one
        posted is kept)."""
        self.store.compare_set(self._key("fault"), "", message)

    def posted(self) -> Optional[str]:
        """The fault posted for this generation, or None."""
        key = self._key("fault")
        if not self.store.check([key]):
            return None
        return self.store.get(key).decode()

    def wait(self, work) -> None:
        """Wait for a collective's ``work``, polling ``is_completed`` (the
        timeout of ``Work.wait`` is not kept by every gloo collective);
        raises :class:`PeerFault` when a fault is posted meanwhile, and
        the collective's own error when it fails."""
        nap, check_at = 1e-4, time.monotonic() + self.poll_s
        while not work.is_completed():
            time.sleep(nap)
            nap = min(2 * nap, 5e-3)
            now = time.monotonic()
            if now >= check_at:
                check_at = now + self.poll_s
                message = self.posted()
                if message is not None:
                    raise PeerFault(message)
        work.wait()

    def arrive(self) -> None:
        """Say that this rank has left the failed step."""
        self.store.set(self._key(f"in/{self.rank}"), "1")

    def missing(self) -> List[int]:
        """The mesh's ranks that have not arrived in this generation."""
        return [r for r in self.ranks
                if not self.store.check([self._key(f"in/{r}")])]

    def beats(self, r: int) -> int:
        """Rank ``r``'s heartbeat count."""
        return int(self.store.add(f"beat/{r}", 0))

    def next_generation(self) -> None:
        """Start the next generation (every rank, after all arrived)."""
        self.generation += 1


def _call(fn, *args, **kwargs) -> None:
    """``fn(*args, **kwargs)``, a collective: at once, or under an armed
    :class:`Fence` issued asynchronously and waited for in polls."""
    fence = _FENCE
    if fence is None:
        fn(*args, **kwargs)
    else:
        fence.wait(fn(*args, async_op=True, **kwargs))


# -------------------------------------------------------- collectives ----
_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}
_MOVED: Dict[str, int] = {}


def _moved(kind: str, x: torch.Tensor) -> None:
    _MOVED[kind] = _MOVED.get(kind, 0) + x.numel() * x.element_size()


def collective_bytes() -> Dict[str, int]:
    """Output bytes of the collectives called since
    :func:`reset_collective_bytes`, by kind (see the module
    docstring)."""
    return dict(_MOVED)


def reset_collective_bytes() -> None:
    """Start :func:`collective_bytes` from nothing."""
    _MOVED.clear()


def all_reduce(x: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    """Reduce ``x`` in place over ``group`` (``op`` "sum" or "max") and
    return it."""
    if group is not None:
        with obs.span("dist.all_reduce", cat="dist", op=op,
                      bytes=x.numel() * x.element_size()):
            _call(dist.all_reduce, x, op=_OPS[op], group=group)
        _moved("all-reduce", x)
    return x


def all_reduce_max(x: torch.Tensor, group) -> torch.Tensor:
    """The elementwise maximum of ``x`` over ``group`` (a new tensor; a
    quantisation scale taken over a whole sharded leaf)."""
    return all_reduce(x.detach().clone(), group, "max")


def all_reduce_by_axes(values: Sequence[torch.Tensor],
                       axes: Sequence[Tuple[str, ...]], mesh,
                       op: str = "sum") -> list:
    """Reduce each of ``values`` (same-shaped tensors, one a leaf) over
    the mesh axes in the same place of ``axes`` (the axes its leaf is
    sharded over; none: left as it is), one collective for each set of
    axes. Returns new tensors."""
    out = list(values)
    buckets: Dict[FrozenSet[str], list] = {}
    for i, names in enumerate(axes):
        key = frozenset(names)
        if key and mesh_axis(mesh, key).group is not None:
            buckets.setdefault(key, []).append(i)
    for key, idx in buckets.items():
        stacked = torch.stack([values[i].detach() for i in idx])
        all_reduce(stacked, mesh_axis(mesh, key).group, op)
        for j, i in enumerate(idx):
            out[i] = stacked[j]
    return out


def broadcast(x: torch.Tensor, group, src: int = 0) -> torch.Tensor:
    """``x`` of group rank ``src``, in place on every rank."""
    if group is None:
        return x
    with obs.span("dist.broadcast", cat="dist",
                  bytes=x.numel() * x.element_size()):
        _call(dist.broadcast, x, src=dist.get_global_rank(group, src),
              group=group)
    _moved("broadcast_", x)
    return x


def _host_side(group) -> torch.device:
    """Where a small tensor for ``group``'s backend lives: the host for
    gloo, this rank's card for nccl."""
    if dist.get_backend(group) == "nccl":
        return local_device("cuda")
    return torch.device("cpu")


def broadcast_int(value: int, group, src: int = 0) -> int:
    """Group rank ``src``'s ``value`` on every rank of ``group``."""
    if group is None:
        return int(value)
    t = torch.tensor([int(value)], dtype=torch.int64,
                     device=_host_side(group))
    broadcast(t, group, src)
    return int(t.item())


def all_gather_ints(value: int, group) -> list:
    """Every rank's ``value`` in group-rank order."""
    if group is None:
        return [int(value)]
    t = torch.tensor([int(value)], dtype=torch.int64,
                     device=_host_side(group))
    return [int(v) for v in all_gather(t, group).tolist()]


def barrier(group) -> None:
    """Wait for every rank of ``group`` (``dist.group.WORLD`` for the
    world; ``None``, one rank, returns at once)."""
    if group is not None:
        _call(dist.barrier, group=group)


def all_gather(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The ranks' ``x`` joined along ``dim`` in group-rank order."""
    if group is None:
        return x
    n = dist.get_world_size(group)
    src = x.detach().movedim(dim, 0).contiguous()
    out = src.new_empty((n * src.shape[0],) + tuple(src.shape[1:]))
    with obs.span("dist.all_gather", cat="dist",
                  bytes=out.numel() * out.element_size()):
        _call(_all_gather_single, out, src, group=group)
    _moved("all-gather", out)
    return out.movedim(0, dim).contiguous()


def reduce_scatter(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """This rank's part along ``dim`` of the sum of the ranks' ``x``
    (``x.shape[dim]`` splits evenly over the group)."""
    if group is None:
        return x
    n = dist.get_world_size(group)
    if x.shape[dim] % n:
        raise ValueError(f"dimension {dim} of {tuple(x.shape)} does not "
                         f"split {n} ways")
    src = x.detach().movedim(dim, 0).contiguous()
    out = src.new_empty((src.shape[0] // n,) + tuple(src.shape[1:]))
    with obs.span("dist.reduce_scatter", cat="dist",
                  bytes=src.numel() * src.element_size()):
        if _FENCE is None:
            _reduce_scatter_single(out, src, group=group)
            _moved("reduce-scatter", out)
        else:
            # gloo's reduce-scatter moves only inside ``Work.wait``, which
            # cannot be polled: under a fence (gloo alone), an all-reduce
            # of which this rank keeps its part
            whole = src.clone()
            _call(dist.all_reduce, whole, group=group)
            out.copy_(whole.narrow(0, dist.get_rank(group) * out.shape[0],
                                   out.shape[0]))
            _moved("all-reduce", whole)
    return out.movedim(0, dim).contiguous()


class _CopyToParallel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce(grad.contiguous().clone(), ctx.group), None


class _ReduceFromParallel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GatherFromParallel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, grad):
        return reduce_scatter(grad, ctx.group, ctx.dim), None, None


class _GatherOutOfParallel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim, ctx.n = group, dim, x.shape[dim]
        return all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, grad):
        index = dist.get_rank(ctx.group)
        return (grad.narrow(ctx.dim, index * ctx.n, ctx.n).contiguous(), None,
                None)


class _MaxFromParallel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        out = all_reduce(x.detach().clone(), group, "max")
        ctx.group = group
        ctx.save_for_backward(x == out)
        return out

    @staticmethod
    def backward(ctx, grad):
        held, = ctx.saved_tensors
        both = all_reduce(torch.stack([grad, held.to(grad.dtype)]),
                          ctx.group)
        return torch.where(held, both[0] / both[1], 0.0), None


def gather_out_of_parallel(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """A column-parallel result (each rank's slice along ``dim``) made
    whole for the replicated stream: the all-gather forward; backward,
    this rank's slice of the gradient, which every rank holds whole and
    the same (Megatron's gather out of the tensor-parallel region)."""
    if group is None:
        return x
    return _GatherOutOfParallel.apply(x, group, dim % x.ndim)


def sum_in_parallel(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of the ranks' partial ``x`` over ``group`` where each rank
    goes on to use it on its own slice of a split dimension (the mean
    square of a norm over it): the all-reduce forward, and backward the
    gradients' sum, since each rank's gradient holds only its slice's
    part."""
    if group is None:
        return x
    return copy_to_parallel(reduce_from_parallel(x, group), group)


def max_from_parallel(x: torch.Tensor, group) -> torch.Tensor:
    """The elementwise maximum of the ranks' ``x`` over ``group`` (each
    rank's maximum of its part of a split tensor): forward a max
    all-reduce; backward the gradients summed over the ranks, each
    element's sum shared by the ranks that hold the maximum (as the
    maximum of the whole tensor passes its gradient to where it lies)."""
    if group is None:
        return x
    return _MaxFromParallel.apply(x, group)


def copy_to_parallel(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` into a column-parallel region: the identity forward, the
    gradients' sum over ``group`` backward (each rank's is partial)."""
    if group is None:
        return x
    return _CopyToParallel.apply(x, group)


def reduce_from_parallel(x: torch.Tensor, group) -> torch.Tensor:
    """Out of a row-parallel region: the sum of the ranks' partial ``x``
    forward, the gradient as it is backward."""
    if group is None:
        return x
    return _ReduceFromParallel.apply(x, group)


def gather_from_parallel(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """A sharded leaf made whole along ``dim`` (all-gather) for use in a
    parallel region; backward sums the ranks' gradients of the whole leaf
    and gives each rank its part (reduce-scatter)."""
    if group is None:
        return x
    return _GatherFromParallel.apply(x, group, dim % x.ndim)


# -------------------------------------------------------------- probe ----
def probe_gloo_cuda() -> Dict[str, str]:
    """Each of :data:`COLLECTIVES` called on CUDA tensors over the
    running gloo world: ``{name: "ok" or the error}``."""
    dev = local_device("cuda")
    n = dist.get_world_size()
    x = torch.arange(4, dtype=torch.float32, device=dev) + dist.get_rank()
    calls = {
        "all_reduce": lambda: dist.all_reduce(x.clone()),
        "all_reduce_int64": lambda: dist.all_reduce(x.to(torch.int64)),
        "all_reduce_max": lambda: dist.all_reduce(x.clone(),
                                                  op=dist.ReduceOp.MAX),
        "broadcast": lambda: dist.broadcast(x.clone(), src=0),
        "all_gather": lambda: _all_gather_single(x.new_empty(4 * n), x),
        "all_gather_int32": lambda: _all_gather_single(
            x.new_empty(4 * n, dtype=torch.int32), x.to(torch.int32)),
        "all_gather_float64": lambda: _all_gather_single(
            x.new_empty(4 * n, dtype=torch.float64), x.to(torch.float64)),
        "reduce_scatter": lambda: _reduce_scatter_single(x.new_empty(4),
                                                         x.repeat(n)),
        "barrier": lambda: dist.barrier(),
    }
    out = {}
    for name, call in calls.items():
        try:
            call()
            torch.cuda.synchronize(dev)
            out[name] = "ok"
        except Exception as e:     # noqa: BLE001 -- the probe's answer
            out[name] = f"{type(e).__name__}: {str(e).splitlines()[0]}"
    return out


if __name__ == "__main__":
    # python -m torch.distributed.run --nproc-per-node 2 -m repro_torch.dist
    import json
    init_distributed("gloo")
    torch.cuda.set_device(local_device("cuda"))
    found = probe_gloo_cuda()
    if dist.get_rank() == 0:
        print(json.dumps({"torch": torch.__version__, "gloo_cuda": found}))
    dist.destroy_process_group()
