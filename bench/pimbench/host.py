"""What the host did during the window's decode steps: the main thread's
CPU time a step beside its wall time. A decode step here is bound by the
host's launches, so a step that takes longer for the same launches and
spends that time on the CPU ran on a slower CPU (a shared core or a lower
clock), not behind the card. Printed on standard error; not compared and
not a metric."""
from __future__ import annotations

import statistics
from typing import Dict, List

__all__ = ["summary"]


def _q(values: List[float]) -> List[float]:
    if len(values) < 2:
        return values * 3
    q = statistics.quantiles(values, n=10, method="inclusive")
    return [round(q[0], 2), round(statistics.median(values), 2),
            round(q[8], 2)]


def summary(steps, kind: str = "decode") -> Dict[str, object]:
    """p10, p50 and p90 of the ``kind`` steps' wall and main-thread CPU
    milliseconds, and the correlation of the two."""
    sel = [s for s in steps if s.kind == kind]
    wall = [s.seconds * 1e3 for s in sel]
    cpu = [s.cpu_s * 1e3 for s in sel]
    out: Dict[str, object] = {"steps": len(sel), "wall_ms": _q(wall),
                              "cpu_ms": _q(cpu), "corr_wall_cpu": None}
    try:
        out["corr_wall_cpu"] = round(statistics.correlation(wall, cpu), 3)
    except (statistics.StatisticsError, ValueError):
        pass
    return out
