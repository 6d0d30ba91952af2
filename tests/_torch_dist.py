"""Spawned groups of ranks for the port's sharded CPU tests.

:func:`run_ranks` starts ``world`` processes with ``torch.multiprocessing``
(spawn), each with one CPU thread and a gloo process group over a
``FileStore``, runs ``fn(rank, *args)`` in each and returns the ranks'
results in rank order; a rank's exception, or the group outliving its
timeout, fails the call. The functions a group runs live in modules that
import no JAX (a spawned rank imports the module of its function).
"""
from __future__ import annotations

import os
import pickle
import tempfile
import time
import traceback

import torch
import torch.multiprocessing as mp

GROUP_TIMEOUT_S = 240.0


def _entry(rank, world, store, out_dir, fn, args):
    torch.set_num_threads(1)
    from repro_torch import dist
    path = os.path.join(out_dir, f"rank{rank}.pkl")
    try:
        dist.init_distributed("gloo", rank=rank, world_size=world,
                              store_path=store, timeout_s=120)
        result = fn(rank, *args)
        with open(path, "wb") as f:
            pickle.dump(("ok", result), f)
    except BaseException:          # reported to the parent, then raised
        with open(path, "wb") as f:
            pickle.dump(("error", traceback.format_exc()), f)
        raise
    finally:
        import torch.distributed as tdist
        if tdist.is_initialized():
            tdist.destroy_process_group()


def run_ranks(fn, world: int, *args, timeout: float = GROUP_TIMEOUT_S,
              may_die=()):
    """``[fn(0, *args), ..., fn(world - 1, *args)]``, each in its own
    process of a gloo group. A rank in ``may_die`` may end by a signal
    (a rank the case kills): its result is None."""
    with tempfile.TemporaryDirectory(prefix="ranks-") as tmp:
        store = os.path.join(tmp, "store")
        ctx = mp.start_processes(_entry, args=(world, store, tmp, fn, args),
                                 nprocs=world, join=False,
                                 start_method="spawn")
        deadline = time.monotonic() + timeout
        try:
            if may_die:
                _join_all(ctx, fn, world, deadline, tmp, may_die)
            else:
                while not ctx.join(timeout=1.0):
                    if time.monotonic() > deadline:
                        raise TimeoutError(f"{world} ranks of "
                                           f"{fn.__name__} outlived "
                                           f"{timeout} s")
        except mp.ProcessRaisedException as e:
            raise AssertionError(_errors(tmp, world) or str(e)) from None
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.terminate()
                    p.join(5)
        out = []
        for r in range(world):
            path = os.path.join(tmp, f"rank{r}.pkl")
            if r in may_die and not os.path.exists(path):
                out.append(None)
                continue
            with open(path, "rb") as f:
                status, what = pickle.load(f)
            assert status == "ok", what
            out.append(what)
        return out


def _errors(tmp: str, world: int) -> str:
    errors = []
    for r in range(world):
        p = os.path.join(tmp, f"rank{r}.pkl")
        if os.path.exists(p):
            with open(p, "rb") as f:
                status, what = pickle.load(f)
            if status == "error":
                errors.append(f"rank {r}:\n{what}")
    return "\n".join(errors)


def _join_all(ctx, fn, world: int, deadline: float, tmp: str,
              may_die) -> None:
    """Wait for every process (``ProcessContext.join`` would end the
    others when one is killed); only ranks in ``may_die`` may end by a
    signal, and any rank's error fails the call."""
    while any(p.is_alive() for p in ctx.processes):
        if time.monotonic() > deadline:
            raise TimeoutError(f"{world} ranks of {fn.__name__} outlived "
                               f"their time")
        time.sleep(0.5)
    for r, p in enumerate(ctx.processes):
        code = p.exitcode
        if code != 0 and not (code < 0 and r in may_die):
            raise AssertionError(_errors(tmp, world)
                                 or f"rank {r} exited {code}")
