"""repro_torch.obs: the port's counterparts of the reference's obs tests
(span tracer, metrics histograms, crossbar waterfall, the instrumented
compile/execute path, logging), the waterfall and ``energy_proxy`` held
equal to the JAX package's, and the port's own logger subtree."""
import json
import logging
import math
import threading

import numpy as np
import pytest

pytest.importorskip("torch")

from repro import obs as ref_obs  # noqa: E402
from repro.core.baselines import rime_multiplier as ref_rime  # noqa: E402
from repro.core.executor import pack_program as ref_pack  # noqa: E402
from repro.engine import Engine as JaxEngine  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.core.baselines import rime_multiplier  # noqa: E402
from repro_torch.core.executor import pack_program  # noqa: E402
from repro_torch.engine import Engine  # noqa: E402
from repro_torch.obs.trace import NULL_SPAN, Tracer  # noqa: E402

pytestmark = pytest.mark.core

CPU = "torch:device=cpu"
# Every compiler family of both packages.
FAMILIES = ["multpim", "multpim_mac", "multpim_area", "rime", "hajali",
            "stage", "recomb", "residue"]


@pytest.fixture()
def global_tracer():
    """Enable the process-wide tracer for one test, then restore the
    disabled-and-empty default so other tests see no overhead/events."""
    t = obs.get_tracer()
    t.reset()
    t.enable()
    yield t
    t.disable()
    t.reset()


@pytest.fixture()
def saved_loggers():
    """Snapshot both packages' root loggers and restore them after the
    test, so configuring one here leaves no state for later tests."""
    saved = {}
    for name in ("repro", "repro_torch"):
        lg = logging.getLogger(name)
        saved[name] = (list(lg.handlers), lg.level, lg.propagate,
                       dict(vars(lg)))
    yield
    for name, (handlers, level, propagate, attrs) in saved.items():
        lg = logging.getLogger(name)
        lg.handlers[:] = handlers
        lg.setLevel(level)
        lg.propagate = propagate
        for key in [k for k in vars(lg) if k not in attrs]:
            delattr(lg, key)


def _logger_state(name):
    lg = logging.getLogger(name)
    return (list(lg.handlers), lg.level, lg.propagate,
            sorted(k for k in vars(lg) if k.endswith("_obs_handler")))


# ------------------------------------------------------------ tracer ----
def test_disabled_span_is_shared_null_span():
    """Disabled tracing must not allocate: every span() call returns the
    one NULL_SPAN singleton and records nothing."""
    t = Tracer()
    assert t.span("a") is NULL_SPAN
    assert t.span("b", op="multpim", n=16) is NULL_SPAN
    with t.span("c") as sp:
        sp.set(x=1)               # no-op, must not raise
    t.instant("d")
    assert len(t) == 0
    assert not obs.enabled()
    assert obs.span("e") is NULL_SPAN
    assert not NULL_SPAN


def test_span_nesting_and_attrs():
    t = Tracer(enabled=True)
    with t.span("outer", op="mul") as outer:
        with t.span("inner"):
            pass
        outer.set(cycles=291)
    evs = t.trace_dict()["traceEvents"]
    spans = {e["name"]: e for e in evs if e["ph"] == "X"}
    assert set(spans) == {"outer", "inner"}
    o, i = spans["outer"], spans["inner"]
    assert o["ts"] <= i["ts"]
    assert i["ts"] + i["dur"] <= o["ts"] + o["dur"] + 1e-6
    assert o["args"] == {"op": "mul", "cycles": 291}
    with t.span("np", v=np.int64(7), f=np.float32(0.5)):
        pass
    ev = [e for e in t.trace_dict()["traceEvents"]
          if e.get("name") == "np"][0]
    assert ev["args"]["v"] == 7
    assert isinstance(ev["args"]["v"], int)


def test_tracer_thread_safety():
    t = Tracer(enabled=True)
    n_threads, per_thread = 8, 50
    gate = threading.Barrier(n_threads)

    def work():
        gate.wait()
        for k in range(per_thread):
            with t.span("w", k=k):
                pass

    threads = [threading.Thread(target=work) for _ in range(n_threads)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=60)
    assert not any(th.is_alive() for th in threads)
    assert len(t) == n_threads * per_thread
    tids = {e["tid"] for e in t.trace_dict()["traceEvents"]
            if e["ph"] == "X"}
    assert len(tids) == n_threads


def test_chrome_trace_schema(tmp_path):
    t = Tracer(enabled=True)
    with t.span("compile", op="multpim"):
        pass
    t.instant("mark")
    t.add_events([{"name": "occupancy", "ph": "C", "ts": 0.0, "pid": 2,
                   "args": {"ops": 3}}])
    path = tmp_path / "trace.json"
    n = t.export(str(path))
    doc = json.loads(path.read_text())
    assert doc["displayTimeUnit"] == "ms"
    evs = doc["traceEvents"]
    assert len(evs) == n == 4               # meta + span + instant + counter
    meta = evs[0]
    assert meta["ph"] == "M" and meta["name"] == "process_name"
    for e in evs:
        assert e["ph"] in ("M", "X", "i", "C")
        assert isinstance(e["pid"], int)
        if e["ph"] == "X":
            assert e["ts"] >= 0 and e["dur"] >= 0


def test_add_events_while_disabled():
    t = Tracer()
    t.add_events([{"name": "x", "ph": "C", "ts": 0, "pid": 2, "args": {}}])
    assert len(t) == 1


def _profiled(fn, tmp_path):
    """``fn()`` under a CPU ``torch.profiler`` with the tracer disabled;
    returns the profiler's export (its events and base) and the tracer's
    events, and leaves the tracer empty."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    t = obs.get_tracer()
    t.reset()
    assert not t.enabled
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            fn()
        path = tmp_path / "prof.json"
        prof.export_chrome_trace(str(path))
        return json.loads(path.read_text()), obs.events()
    finally:
        t.reset()
        assert not torch.autograd.profiler._is_profiler_enabled


def test_span_records_under_the_profiler_with_its_twin(tmp_path):
    """With the tracer disabled, a span records while torch.profiler
    records: its profiler range of the same name is in the profiler's
    export, and the range's ts + baseTimeNanoseconds / 1e3 is the span's
    ts (CLOCK_REALTIME microseconds), within 500 us."""
    def work():
        for k in range(3):             # the first ranges are the slowest
            with obs.span(f"warm{k}"):
                pass
        with obs.span("timed", n=3):
            pass

    prof, events = _profiled(work, tmp_path)
    twins = {e["name"]: e for e in prof["traceEvents"]
             if e.get("cat") in ("cpu_op", "user_annotation")}
    ours = {e["name"]: e for e in events if e["ph"] == "X"}
    assert {"warm0", "warm1", "warm2", "timed"} <= set(twins) & set(ours)
    assert ours["timed"]["args"] == {"n": 3}
    base_us = prof["baseTimeNanoseconds"] / 1e3
    assert abs(twins["timed"]["ts"] + base_us - ours["timed"]["ts"]) < 500
    assert obs.span("after") is NULL_SPAN


class _Kineto:
    """A stand-in for one of ``torch.profiler``'s ``_KinetoEvent``s: an
    operator or range (``op``), a runtime call linked to operator
    ``link`` (``call``), a device operation (``gpu``) or the device's
    copy of a user annotation (``gpu_range``)."""

    def __init__(self, kind, name="", corr=0, start=0, dur=0, link=0):
        self._kind, self._name, self._link = kind, name, link
        self._corr, self._start, self._dur = corr, start, dur

    def device_type(self):
        import torch
        cpu = self._kind in ("op", "call")
        return torch.autograd.DeviceType.CPU if cpu else \
            torch.autograd.DeviceType.CUDA

    def is_user_annotation(self):
        return self._kind == "gpu_range"

    def linked_correlation_id(self):
        return self._link

    def name(self):
        return self._name

    def correlation_id(self):
        return self._corr

    def start_ns(self):
        return self._start

    def duration_ns(self):
        return self._dur


def test_device_time_is_the_kernels_launched_inside_each_range():
    """``_device_ns``: a range's device time sums the device operations
    whose runtime launch starts inside it, nested ranges each counting
    theirs; an operator whose correlation id equals a launch's does not
    stand for it; the device's copy of a range is no device operation; a
    launch outside every range counts nowhere; without device operations
    there is nothing."""
    from repro_torch.obs.trace import _device_ns
    ev = [_Kineto("op", "pim.linear", 1, 100, 900),
          _Kineto("op", "pim.weight", 2, 150, 300),
          _Kineto("op", "pim.linear", 3, 2000, 500),
          _Kineto("op", "other", 4, 0, 10 ** 6),
          _Kineto("op", "aten::abs", 11, 5000, 10),
          _Kineto("call", "cudaLaunchKernel", 11, 200, 5, link=5),
          _Kineto("call", "cudaLaunchKernel", 12, 600, 5, link=6),
          _Kineto("call", "cudaMemcpyAsync", 13, 2100, 5, link=7),
          _Kineto("call", "cudaLaunchKernel", 14, 3000, 5, link=8),
          _Kineto("gpu", "abs", 11, 9000, 70, link=5),
          _Kineto("gpu", "gemm", 12, 9100, 400, link=6),
          _Kineto("gpu", "copy", 13, 9600, 30, link=7),
          _Kineto("gpu", "late", 14, 9700, 5, link=8),
          _Kineto("gpu_range", "pim.linear", 1, 9000, 700)]
    got = _device_ns(ev, {"pim.linear", "pim.weight"})
    assert got == {"pim.linear": [[100, 1000, 470], [2000, 2500, 30]],
                   "pim.weight": [[150, 450, 70]]}
    assert _device_ns(ev[:9] + ev[-1:], {"pim.linear"}) == {}


def test_profiler_stop_gives_spans_their_twins_device_time(monkeypatch,
                                                           tmp_path):
    """At the profiler's stop each span of that segment gets its twin's
    device time, paired in start order per name; a name whose spans and
    twins differ in number gets none; the stop still hands the profiler
    its results (its export works)."""
    from repro_torch.obs import trace
    real = trace._device_ns
    seen = []

    def device_ns(events, names):
        ranges = real(events, names)      # the CPU profile: no kernels
        assert ranges == {}
        seen.append(sorted(names))
        return {"a": [[0, 1, 7000], [0, 1, 9000]], "b": [[0, 1, 5]]}

    monkeypatch.setattr(trace, "_device_ns", device_ns)

    def work():
        for _ in range(2):
            with obs.span("a"):
                with obs.span("b"):
                    pass
                with obs.span("b"):
                    pass

    prof, events = _profiled(work, tmp_path)
    assert seen == [["a", "b"]]
    assert [e for e in prof["traceEvents"] if e.get("name") == "a"]
    got = [(e["name"], e.get("args", {}).get("device_us"))
           for e in sorted(events, key=lambda e: e["id"])]
    assert got == [("a", 7.0), ("b", None), ("b", None), ("a", 9.0),
                   ("b", None), ("b", None)]


def test_span_parent_ids_nest():
    """Every recorded span has an id; its parent is the span open around
    it on the same thread (None at the top), siblings share a parent."""
    t = Tracer(enabled=True)
    with t.span("step"):
        with t.span("a"):
            with t.span("a1"):
                pass
        with t.span("b"):
            pass
    with t.span("next"):
        pass
    ev = {e["name"]: e for e in t.events() if e["ph"] == "X"}
    assert len({e["id"] for e in ev.values()}) == 5
    assert ev["step"]["parent"] is None and ev["next"]["parent"] is None
    assert ev["a"]["parent"] == ev["b"]["parent"] == ev["step"]["id"]
    assert ev["a1"]["parent"] == ev["a"]["id"]


def _pim_tree(events):
    """{span name: [its parent's name, ...]} of the recorded spans."""
    spans = [e for e in events if e["ph"] == "X"]
    by_id = {e["id"]: e for e in spans}
    tree = {}
    for e in spans:
        parent = by_id.get(e["parent"], {}).get("name")
        tree.setdefault(e["name"], []).append(parent)
    return tree, spans


@pytest.mark.parametrize("ragged", [False, True])
def test_engine_pim_linear_span_tree(global_tracer, ragged):
    """Engine.linear and ragged_linear in pim mode on the CPU: one
    pim.linear (pim.ragged_linear) span with its shapes, over one span of
    each phase (and, ragged, the counts' pim.dispatch); pim.weight holds
    the weight's bytes, 4 K N a float32 matrix; no device times on the
    CPU."""
    import torch

    eng = Engine(CPU)
    g = torch.Generator().manual_seed(0)
    x = torch.randn(6, 16, generator=g)
    if ragged:
        w = torch.randn(3, 16, 5, generator=g)
        eng.ragged_linear(x, w, torch.tensor([2, 0, 3]))
        top, args = "pim.ragged_linear", {"rows": 6, "k": 16, "n": 5,
                                          "experts": 3, "bits": 8}
        phases = {"pim.weight", "pim.activation", "pim.dispatch",
                  "pim.product", "pim.dequant"}
    else:
        w = torch.randn(16, 5, generator=g)
        eng.linear(x.reshape(2, 3, 16), w)
        top, args = "pim.linear", {"rows": 6, "k": 16, "n": 5, "bits": 8}
        phases = {"pim.weight", "pim.activation", "pim.product",
                  "pim.dequant"}
    tree, spans = _pim_tree(obs.events())
    assert tree[top] == [None]
    for name in phases:
        assert tree[name] == [top], name
    one = {e["name"]: e for e in spans}
    assert one[top]["args"] == args
    assert one["pim.weight"]["args"] == {"bytes": 4 * w.numel()}
    assert one["pim.activation"]["args"] == {"bytes": 4 * x.numel()}
    assert not any("device_us" in e.get("args", {}) for e in spans)


def _weight_cache():
    """(hits, misses) of the PIM weight cache so far."""
    return (obs.counter("pim.weight_cache.hit").value,
            obs.counter("pim.weight_cache.miss").value)


def test_engine_pim_linear_keeps_the_weight(global_tracer, monkeypatch):
    """A dense pim-mode weight is quantized once: the first call's
    pim.weight holds the float32 weight's bytes (4 K N) and counts a miss,
    the second's only the widening of the kept uint8 levels (K N bytes,
    ``cached``) and counts a hit. ragged_linear, a row-parallel call
    (``k_group``: here a world of one, whose collectives are the
    identity) and mode="fake" count neither, on the same weight too."""
    import torch

    from repro_torch import dist

    eng = Engine(CPU)
    g = torch.Generator().manual_seed(2)
    x = torch.randn(6, 16, generator=g)
    w = torch.randn(16, 5, generator=g)
    before = _weight_cache()
    first = eng.linear(x, w)
    assert torch.equal(eng.linear(x, w), first)
    spans = _pim_tree(obs.events())[1]
    assert [e["args"] for e in spans if e["name"] == "pim.weight"] == [
        {"bytes": 4 * 16 * 5}, {"bytes": 16 * 5, "cached": True}]
    after = _weight_cache()
    assert (after[0] - before[0], after[1] - before[1]) == (1, 1)
    monkeypatch.setattr(dist, "max_from_parallel", lambda t, group: t)
    monkeypatch.setattr(dist, "all_reduce", lambda t, group, op="sum": t)
    we, counts = torch.randn(3, 16, 5, generator=g), torch.tensor([2, 0, 3])
    for _ in range(2):
        eng.ragged_linear(x, we, counts)
        assert torch.equal(eng.linear(x, w, k_group=object()), first)
        eng.linear(x, w, mode="fake")
    assert _weight_cache() == after


@pytest.mark.parametrize("ragged", [False, True])
def test_engine_pim_linear_same_bits_traced(ragged):
    """The phase spans change no result: linear and ragged_linear give
    bit-identical outputs with tracing off and on."""
    import torch

    eng = Engine(CPU)
    g = torch.Generator().manual_seed(1)
    x = torch.randn(7, 32, generator=g) * 3
    if ragged:
        w = torch.randn(4, 32, 9, generator=g)
        counts = torch.tensor([3, 0, 2, 1])

        def call():
            return eng.ragged_linear(x, w, counts)
    else:
        w, b = torch.randn(32, 9, generator=g), torch.randn(9, generator=g)

        def call():
            return eng.linear(x, w, b)
    off = call()
    t = obs.get_tracer()
    t.reset()
    t.enable()
    try:
        on = call()
        assert len(t) > 0
    finally:
        t.disable()
        t.reset()
    assert torch.equal(off, on)


# ----------------------------------------------------------- metrics ----
def test_histogram_nearest_rank_percentiles():
    h = obs.Histogram("t")
    for v in range(1, 11):
        h.observe(v)
    assert h.percentile(0.50) == 5
    assert h.percentile(0.90) == 9
    assert h.percentile(0.99) == 10
    assert h.count == 10 and h.total == 55 and h.mean == 5.5
    snap = h.snapshot()
    assert snap["min"] == 1 and snap["max"] == 10
    assert snap["p50"] == 5 and snap["p90"] == 9 and snap["p99"] == 10
    assert math.isnan(obs.Histogram("empty").percentile(0.5))


def test_histogram_reservoir_bounded():
    h = obs.Histogram("r", cap=64)
    for v in range(1000):
        h.observe(v)
    assert len(h._sample) == 64
    assert h.count == 1000
    assert h._min == 0 and h._max == 999
    assert 250 <= h.percentile(0.5) <= 750


def test_registry_identity_and_reset():
    reg = obs.Registry()
    c = reg.counter("hits")
    c.inc(3)
    assert reg.counter("hits") is c
    g = reg.gauge("tps")
    g.set(12.5)
    h = reg.histogram("lat")
    h.observe(1.0)
    d = reg.dump()
    assert d["counters"]["hits"] == 3
    assert d["gauges"]["tps"] == 12.5
    assert d["histograms"]["lat"]["count"] == 1
    reg.reset()
    assert reg.counter("hits") is c
    assert c.value == 0
    assert reg.histogram("lat").count == 0


def test_registry_write(tmp_path):
    reg = obs.Registry()
    reg.counter("a").inc()
    path = tmp_path / "m.json"
    doc = reg.write(str(path), extra={"run": "test"})
    on_disk = json.loads(path.read_text())
    assert on_disk["counters"]["a"] == 1 == doc["counters"]["a"]
    assert on_disk["run"] == "test"


def test_windowed_histogram_window_vs_cumulative():
    h = obs.WindowedHistogram("wh.lat")
    for v in (1.0, 2.0, 3.0, 4.0):
        h.observe(v)
    w = h.window()
    assert w["count"] == 4 and w["min"] == 1.0 and w["max"] == 4.0
    assert w["p50"] == 2.0 and w["p99"] == 4.0
    h.observe(10.0)
    h.observe(20.0)
    w2 = h.window(reset=False)
    assert w2["count"] == 2 and w2["min"] == 10.0 and w2["p50"] == 10.0
    assert h.window()["count"] == 2
    assert h.window()["count"] == 0
    assert math.isnan(h.window()["p50"])
    assert h.snapshot()["count"] == 6
    assert h.percentile(1.0) == 20.0


def test_windowed_histogram_registry_identity_and_guard():
    reg = obs.Registry()
    w1 = reg.windowed_histogram("wh.reg")
    assert reg.windowed_histogram("wh.reg") is w1
    assert reg.histogram("wh.reg") is w1
    reg.histogram("wh.plain")
    with pytest.raises(TypeError):
        reg.windowed_histogram("wh.plain")


def test_windowed_histogram_reset_wipes_window():
    reg = obs.Registry()
    h = reg.windowed_histogram("wh.reset")
    h.observe(5.0)
    reg.reset()
    assert reg.windowed_histogram("wh.reset") is h
    assert h.window()["count"] == 0
    assert h.snapshot()["count"] == 0


def test_windowed_histogram_window_deterministic_beyond_cap():
    a = obs.WindowedHistogram("wh.det", cap=8)
    b = obs.WindowedHistogram("wh.det", cap=8)
    for i in range(100):
        a.observe(float(i))
        b.observe(float(i))
    assert a.window() == b.window()


def test_counter_track_events_schema(global_tracer, tmp_path):
    obs.track("serve.sched", queue_depth=3, live=2, k=4)
    obs.track("serve.sched", queue_depth=0, live=1, k=1)
    path = tmp_path / "trace.json"
    obs.export_trace(str(path))
    evs = [e for e in json.loads(path.read_text())["traceEvents"]
           if e.get("ph") == "C" and e["name"] == "serve.sched"]
    assert len(evs) == 2
    assert evs[0]["pid"] == 1
    assert evs[0]["args"] == {"queue_depth": 3, "live": 2, "k": 4}
    assert evs[0]["ts"] <= evs[1]["ts"]


def test_counter_track_noop_when_disabled():
    t = Tracer()
    t.counter("serve.sched", queue_depth=9)
    assert len(t) == 0


# --------------------------------------------------------- waterfall ----
def test_cycle_occupancy_matches_program_spans():
    """Occupancy series agree with spans recomputed straight from the
    Program IR, and with the reference's waterfall."""
    prog = rime_multiplier(8)
    occ = obs.cycle_occupancy(prog)
    T = prog.n_cycles
    assert all(len(occ[k]) == T for k in occ)
    lay = prog.layout
    for t, cyc in enumerate(prog.cycles):
        if cyc.is_init:
            assert occ["init"][t] == 1 and occ["ops"][t] == 0
            assert occ["cols_written"][t] == len(cyc.init_cells)
            parts = {lay.partition_of(c) for c in cyc.init_cells}
            assert occ["partitions_busy"][t] == len(parts)
        else:
            assert occ["init"][t] == 0
            assert occ["ops"][t] == len(cyc.ops)
            assert occ["cols_written"][t] == len({op.out for op in cyc.ops})
            width = 0
            for op in cyc.ops:
                ps = [lay.partition_of(c) for c in op.cols]
                width += max(ps) - min(ps) + 1
            assert occ["partitions_busy"][t] == width
    assert max(occ["ops"]) >= 1 and sum(occ["cols_written"]) > 0
    assert occ == ref_obs.cycle_occupancy(ref_rime(8))


def test_switching_profile_deterministic_and_guarded():
    packed = pack_program(rime_multiplier(4))
    p1 = obs.switching_profile(packed)
    p2 = obs.switching_profile(packed)
    assert np.array_equal(p1, p2)
    assert p1.shape == (packed.n_cycles,)
    assert (p1 >= 0).all() and p1.sum() > 0
    with pytest.raises(ValueError):
        obs.switching_profile(packed, rows=100)   # not a multiple of 64
    p3 = obs.switching_profile(packed, seed=1)
    assert p3.shape == p1.shape
    ref = ref_pack(ref_rime(4))
    for seed in (0, 1):
        assert np.array_equal(obs.switching_profile(packed, seed=seed),
                              ref_obs.switching_profile(ref, seed=seed))


def test_switching_activity_memoized():
    packed = pack_program(rime_multiplier(4))
    v1 = obs.switching_activity(packed)
    assert v1 > 0
    memo = packed._energy_proxy
    assert memo == ((64, 0), v1)
    assert obs.switching_activity(packed) == v1
    assert packed._energy_proxy is memo         # cache hit, not recompute


def test_waterfall_events_schema():
    prog = rime_multiplier(4)
    packed = pack_program(prog)
    evs = obs.waterfall_events(prog, packed=packed, name="rime N=4", pid=3)
    assert evs[0]["ph"] == "M"
    assert "rime N=4" in evs[0]["args"]["name"]
    occ_evs = [e for e in evs if e.get("name") == "occupancy"]
    sw_evs = [e for e in evs if e.get("name") == "switching"]
    T = prog.n_cycles
    assert len(occ_evs) == len(sw_evs) == T + 1
    assert all(e["ph"] == "C" and e["pid"] == 3 for e in occ_evs + sw_evs)
    assert set(occ_evs[-1]["args"].values()) == {0}
    assert sw_evs[-1]["args"]["bit_flips_per_row"] == 0.0
    occ = obs.cycle_occupancy(prog)
    assert [e["args"]["ops"] for e in occ_evs[:-1]] == occ["ops"]
    assert occ_evs[1]["ts"] == pytest.approx(10.0 / 1e3)
    ref_prog = ref_rime(4)
    assert evs == ref_obs.waterfall_events(
        ref_prog, packed=ref_pack(ref_prog), name="rime N=4", pid=3)
    tracked = obs.waterfall_events(prog, track="ch0.bg0.b0.x1")
    assert tracked[1]["name"] == "ch0.bg0.b0.x1/occupancy"


def test_exec_cost_energy_proxy():
    cost = Engine(CPU).compile("multpim", 8).cost()
    assert cost.energy_proxy is not None and cost.energy_proxy > 0
    assert cost.as_dict()["energy_proxy"] == cost.energy_proxy
    # a resident chain reports none, as the reference's does
    assert Engine(CPU).resident(8, rows=4).cost().energy_proxy is None


@pytest.mark.parametrize("kind", FAMILIES)
def test_energy_proxy_matches_reference(kind):
    """ExecCost.energy_proxy equals the reference's for every compiler
    family, and for a co-scheduled pass of two copies."""
    got = Engine(CPU).compile(kind, 8).cost()
    want = JaxEngine().compile(kind, 8).cost()
    assert got.energy_proxy == want.energy_proxy
    assert got.energy_uj == want.energy_uj and got.cycles == want.cycles
    if kind in ("multpim", "multpim_mac", "multpim_area", "rime"):
        batch = Engine(CPU).compile_batch(kind, 8, 2).cost()
        assert batch.energy_proxy == JaxEngine().compile_batch(
            kind, 8, 2).cost().energy_proxy


# --------------------------------------- instrumented compile/execute ----
def test_instrumented_engine_emits_expected_spans(global_tracer):
    from repro_torch.compiler import ProgramCache

    eng = Engine(CPU, cache=ProgramCache(use_disk=False))
    exe = eng.compile("multpim", 4)
    rng = np.random.default_rng(0)
    batch = {"a": rng.integers(0, 16, 8), "b": rng.integers(0, 16, 8)}
    exe.run(batch)
    names = {e["name"] for e in global_tracer.trace_dict()["traceEvents"]}
    for expect in ("engine.compile", "cache.compile", "compile.build",
                   "compile.optimize", "compile.pack", "exec.run",
                   "exec.marshal", "exec.unmarshal", "backend.kernel"):
        assert expect in names, f"missing span {expect}"
    n_compiles = sum(1 for e in global_tracer.trace_dict()["traceEvents"]
                     if e["name"] == "cache.compile")
    eng.compile("multpim", 4)
    assert sum(1 for e in global_tracer.trace_dict()["traceEvents"]
               if e["name"] == "cache.compile") == n_compiles
    assert obs.counter("cache.memory_hit").value >= 1


def test_instrumentation_silent_when_disabled():
    from repro_torch.compiler import ProgramCache

    t = obs.get_tracer()
    t.reset()
    assert not t.enabled
    eng = Engine(CPU, cache=ProgramCache(use_disk=False))
    exe = eng.compile("multpim", 4)
    exe.run({"a": np.arange(8), "b": np.arange(8)})
    assert len(t) == 0


# ----------------------------------------------------------- logging ----
def test_setup_logging_idempotent_and_scoped(saved_loggers):
    root_before = list(logging.getLogger().handlers)
    obs.setup_logging()
    obs.setup_logging()                     # second call must not stack
    port_log = logging.getLogger("repro_torch")
    marked = [h for h in port_log.handlers
              if getattr(h, "_repro_torch_obs_handler", False)]
    assert len(marked) == 1
    assert port_log.propagate is False
    assert logging.getLogger().handlers == root_before
    assert obs.get_logger("serve").name == "repro_torch.serve"
    assert obs.get_logger("repro_torch.x").name == "repro_torch.x"


def test_loggers_are_apart_from_the_reference(saved_loggers):
    """The port's logger is not the reference's, and setting up either
    package's logging leaves the other package's logger as it was."""
    assert obs.get_logger("serve") is not ref_obs.get_logger("serve")
    assert ref_obs.get_logger("serve").name == "repro.serve"
    ref_before = _logger_state("repro")
    obs.setup_logging()
    assert _logger_state("repro") == ref_before
    port_before = _logger_state("repro_torch")
    ref_obs.setup_logging()
    assert _logger_state("repro_torch") == port_before


def test_launcher_logger_and_import_leave_logging_alone():
    """Importing the port's launcher touches no global logging state,
    and its logger lives under the port's subtree."""
    import importlib

    root_before = list(logging.getLogger().handlers)
    import repro_torch.launch.serve as serve
    importlib.reload(serve)
    assert logging.getLogger().handlers == root_before
    assert serve.log.name == "repro_torch.serve"
