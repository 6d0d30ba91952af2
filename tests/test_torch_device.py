"""repro_torch.device against the JAX package's ``repro.device``: the
command-trace text round-trip, bit-exact replay of recorded group passes
through the port's engine (packed and unpacked, on the CPU), traces that
cross between the packages in both directions and dump byte for byte
alike, the hierarchical cost model over planned blocks, and the copied
model configs."""
import dataclasses

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.configs import ARCHS as REF_ARCHS  # noqa: E402
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.device import CommandTrace as RefTrace  # noqa: E402
from repro.device import CoordAllocator as RefAllocator  # noqa: E402
from repro.device import DeviceConfig as RefDeviceConfig  # noqa: E402
from repro.device import TraceRecorder as RefRecorder  # noqa: E402
from repro.device import block_trace as ref_block_trace  # noqa: E402
from repro.device import charge as ref_charge  # noqa: E402
from repro.engine import Engine as JaxEngine  # noqa: E402
from repro.pim import plan_block as ref_plan_block  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.configs import ARCHS, get_config  # noqa: E402
from repro_torch.core.costmodel import CrossbarSpec  # noqa: E402
from repro_torch.device import (CommandTrace, Coord,  # noqa: E402
                                CoordAllocator, DeviceCapacityError,
                                DeviceConfig, TraceRecorder, block_trace,
                                charge)
from repro_torch.device.cost import DeviceCostReport  # noqa: E402
from repro_torch.device.trace import Record, _pack_value  # noqa: E402
from repro_torch.engine import Engine  # noqa: E402
from repro_torch.pim import plan_block  # noqa: E402

from _prop import given, settings, st  # noqa: E402

pytestmark = pytest.mark.pim

PORT = ["torch:device=cpu,pack=true", "torch:device=cpu,pack=false"]
# The reference example's MAC group (examples/device_sim.py) at n = 8,
# and a heterogeneous group of two multipliers with integer operands.
MAC_GROUP = [("mac", 8, 2, "w1"), ("mac", 8, 1, "w3")]
MUL_GROUP = [("multpim", 8, 1, "m"), ("rime", 8, 1, "r")]


def _batches(eng, group, rows, seed):
    """Seeded operand sets for one pass of ``group`` on ``eng``: MAC
    slots get serve-path bit planes, multipliers get integers."""
    rng = np.random.default_rng(seed)
    zeros = np.zeros(rows, dtype=object)
    out = []
    for op, n, copies, _ in group:
        for _ in range(copies):
            a = rng.integers(0, 1 << (n - 2), rows)
            b = rng.integers(0, 1 << (n - 2), rows)
            out.append(eng.mac_inputs(n, a, b, zeros, zeros) if op == "mac"
                       else {"a": a, "b": b})
    return out


def _record(eng, rec, group, passes=2, rows=5, seed=7):
    """Record ``passes`` passes of ``group`` through ``rec``; returns the
    direct results of each pass."""
    gex = eng.compile_group(group)
    return [gex.run(_batches(eng, group, rows, seed + p), recorder=rec)
            for p in range(passes)]


def _port_trace(backend=PORT[0], shape="1x1x1x2"):
    eng = Engine(backend)
    rec = TraceRecorder(DeviceConfig.parse(shape, crossbar=eng.crossbar))
    direct = [_record(eng, rec, g) for g in (MAC_GROUP, MUL_GROUP)]
    return rec.trace, direct


def _ref_trace(shape="1x1x1x2"):
    eng = JaxEngine()
    rec = RefRecorder(RefDeviceConfig.parse(shape, crossbar=eng.crossbar))
    for g in (MAC_GROUP, MUL_GROUP):
        _record(eng, rec, g)
    return rec.trace


# ============================================== trace record round-trip ====
def test_trace_text_roundtrip():
    eng = Engine(PORT[0])
    dev = DeviceConfig.parse("2x1x2x2", crossbar=eng.crossbar)
    tr = CommandTrace(dev)
    tr.add("PROG", members="multpim_mac:8:2:w1|multpim:8:1:")
    tr.add("H2D", payload={"a": [3, 5 << 70], "b": [2, 7]},
           dst=Coord(0, 0, 0, 1), slot=0, prog=1, bytes=4, planes="a")
    tr.add("BARRIER", after="head")
    text = tr.dumps()
    back = CommandTrace.loads(text)
    assert str(back.device) == "2x1x2x2"
    assert back.device.crossbar.rows == eng.crossbar.rows
    assert [r.kind for r in back.records] == [r.kind for r in tr.records]
    # payload integers are unbounded-precision and survive exactly
    h2d = back.by_kind("H2D")[0]
    assert h2d.payload == {"a": [3, 5 << 70], "b": [2, 7]}
    assert h2d.fields["dst"] == "ch0.bg0.b0.x1"
    # the PROG table recompiles to the port's GroupSpecs in slot order
    specs = back.progs()[1]
    assert type(specs[0]).__module__.startswith("repro_torch.")
    assert [(s.op, s.n, s.copies) for s in specs] == [
        ("multpim_mac", 8, 2), ("multpim", 8, 1)]
    # dumps() of the reload is byte-identical, and equals the reference's
    assert back.dumps() == text
    ref = RefTrace.loads(text)
    assert ref.dumps() == text


def test_trace_rejects_garbage():
    with pytest.raises(ValueError):
        CommandTrace.loads("EXEC id=0 prog=1\n")       # no DEVICE first
    with pytest.raises(ValueError):
        Record.parse("NOPE id=0")
    with pytest.raises(ValueError):
        Record.parse("EXEC prog=1")                    # id missing
    with pytest.raises(ValueError):
        CommandTrace(DeviceConfig.parse("1x1x1x1")).add("NOPE")


# ====================================================== recorded replay ====
@pytest.mark.parametrize("backend", PORT)
def test_replay_bit_identical_to_direct(backend):
    """Serialize -> parse -> replay through a fresh engine on each port
    backend: every D2H record checks, and the replayed slots equal the
    direct run, slot for slot, bit for bit."""
    trace, direct = _port_trace(backend)
    back = CommandTrace.loads(trace.dumps())
    checked = back.verify_replay(Engine(backend))
    assert checked == len(back.by_kind("D2H")) == 2 * (3 + 2)
    replayed = back.replay(Engine(backend))
    flat = [slots for group in direct for slots in group]
    assert len(replayed) == len(flat)
    for (ex_id, got), want in zip(sorted(replayed.items()), flat):
        assert got == [{name: _pack_value(name, vals)[0]
                        for name, vals in slot.items()} for slot in want]


@pytest.mark.parametrize("backend", PORT)
def test_reference_trace_replays_in_port(backend):
    """A trace the JAX package recorded loads in the port and passes
    verify_replay through the port's engine."""
    text = _ref_trace().dumps()
    back = CommandTrace.loads(text)
    assert back.dumps() == text
    assert back.verify_replay(Engine(backend)) == 10


@pytest.mark.parametrize("backend", PORT)
def test_port_trace_replays_in_reference(backend):
    """The reverse: a trace the port recorded passes the reference's
    verify_replay on its numpy and packed jax backends."""
    text = _port_trace(backend)[0].dumps()
    ref = RefTrace.loads(text)
    assert ref.dumps() == text
    assert ref.verify_replay(JaxEngine("numpy")) == 10
    assert ref.verify_replay(JaxEngine("numpy"),
                             backend="jax:pack=true,macro=1") == 10


@pytest.mark.parametrize("shape", ["1x1x1x2", "2x1x2x2"])
def test_dumps_byte_identical_across_packages(shape):
    """The same seeded run dumps the same text in both packages: the
    DEVICE record, PROG members, payloads, placement and the EXEC cost
    fields (cycles, energy_uj) all agree."""
    port = _port_trace(shape=shape)[0].dumps()
    ref = _ref_trace(shape=shape).dumps()
    assert port == ref
    assert port.startswith("# repro.device command trace")


def test_replay_detects_corruption():
    trace, _ = _port_trace()
    d2h = trace.by_kind("D2H")[0]
    name = next(iter(d2h.payload))
    d2h.payload[name] = [v + 1 for v in d2h.payload[name]]
    with pytest.raises(AssertionError):
        trace.verify_replay(Engine(PORT[0]))


def test_recorder_auto_places_and_binds_once():
    eng = Engine(PORT[0])
    dev = DeviceConfig.parse("1x1x1x2", crossbar=eng.crossbar)
    rec = TraceRecorder(dev)
    gex = eng.compile_group([("mac", 8, 1, "w1")])
    batch = _batches(eng, [("mac", 8, 1, "w1")], 2, 0)
    gex.run(batch, recorder=rec)
    gex.run(batch, recorder=rec)          # same gex: same PROG, coord
    assert len(rec.trace.by_kind("PROG")) == 1
    execs = rec.trace.by_kind("EXEC")
    assert len(execs) == 2
    assert execs[0].fields["at"] == execs[1].fields["at"] == "ch0.bg0.b0.x0"
    # a second executable lands on the next crossbar
    other = eng.compile_group([("multpim", 4, 1, "m")])
    other.run([{"a": [3], "b": [5]}], recorder=rec)
    assert rec.trace.by_kind("EXEC")[-1].fields["at"] == "ch0.bg0.b0.x1"


# ================================================ degeneracy properties ====
def _head_plan(eng):
    cfg = dataclasses.replace(get_config("gemma2-9b"),
                              pim_linear_mode="pim", pim_block_mode="none")
    return plan_block(cfg, eng, scopes=("head",))


def test_degenerate_device_reproduces_flat_cycles_and_energy():
    """A 1x1x1x1 device adds nothing: critical path == the flat plan's
    cycles/token, zero hop latency, and gate energy == the group's flat
    ExecCost.energy_uj x passes."""
    eng = Engine(PORT[0])
    plan = _head_plan(eng)
    dev = DeviceConfig.parse("1x1x1x1", crossbar=eng.crossbar)
    rep = charge(block_trace(plan, dev))
    assert rep.crit_cycles == plan.cycles_per_token
    assert rep.busy_cycles == plan.cycles_per_token
    assert rep.hop_ns == 0.0
    (g,) = plan.groups
    want = g.executable.cost().energy_uj * g.passes_per_token
    assert rep.exec_energy_uj == pytest.approx(want)
    assert rep.transfer_us > 0 and rep.row_energy_uj > 0
    assert rep.levels[0]["utilization"] == pytest.approx(1.0)


@settings(max_examples=10)
@given(st.integers(min_value=1, max_value=4))
def test_tokens_scale_trace_not_throughput(tokens):
    """T tokens emit T x the records and T x the cost, so per-token
    throughput is invariant — and capacity() divides through."""
    eng = Engine(PORT[0])
    plan = _head_plan(eng)
    dev = DeviceConfig.parse("1x1x1x1", crossbar=eng.crossbar)
    one = charge(block_trace(plan, dev, tokens=1), tokens=1)
    many = charge(block_trace(plan, dev, tokens=tokens), tokens=tokens)
    assert many.crit_cycles == tokens * one.crit_cycles
    assert many.tokens_per_sec == pytest.approx(one.tokens_per_sec)
    assert one.capacity(one.tokens_per_sec * 2.5) == 3
    assert one.capacity(0) == 0


def test_charge_phases_hops_and_transfers():
    """Hand-built trace: concurrent EXECs inside a phase charge the max,
    phases sum, MOV/BCAST charge the differing level, H2D uses the host
    link; the reference charges the same text to the same report."""
    dev = DeviceConfig.parse("2x2x4x4", crossbar=CrossbarSpec())
    tr = CommandTrace(dev)
    a, b = Coord(0, 0, 0, 0), Coord(0, 0, 1, 0)
    tr.add("H2D", dst=a, slot=0, bytes=16_000)
    tr.add("EXEC", prog=-1, at=a, k=1, cycles=100, rows=8, passes=2,
           energy_uj=1.5, **{"in": ""})
    tr.add("EXEC", prog=-1, at=b, k=1, cycles=40, rows=8, passes=1,
           energy_uj=0.5, **{"in": ""})
    tr.add("BARRIER", after="p0")
    tr.add("EXEC", prog=-1, at=b, k=1, cycles=60, rows=8, passes=1,
           energy_uj=0.5, **{"in": ""})
    tr.add("MOV", src=a, dst=b, bytes=10)            # bank hop
    tr.add("BCAST", src=a, dst=f"{Coord(0, 0, 0, 1)},{Coord(1, 0, 0, 0)}",
           bytes=10)                                 # worst dst: channel
    tr.add("BARRIER", after="p1")
    rep = charge(tr)
    assert rep.crit_cycles == 100 + 60               # max(100,40) + 60
    assert rep.busy_cycles == 200
    assert rep.hop_ns == dev.bank_hop_ns + dev.channel_hop_ns
    assert rep.transfer_us == pytest.approx(
        16_000 / (dev.host_bw_gbps * 1e3))
    assert rep.exec_energy_uj == pytest.approx(2.5)
    assert rep.row_energy_uj == pytest.approx(
        32 * dev.row_activation_pj / 1e6)
    by = {r["level"]: r for r in rep.levels}
    assert by["crossbar"]["used"] == 2
    assert by["bank"]["used"] == 2 and by["device"]["used"] == 1
    assert ref_charge(RefTrace.loads(tr.dumps())).as_dict() == rep.as_dict()
    assert "critical path" in rep.summary()


def _full_cfg(get):
    return dataclasses.replace(get("gemma2-9b"), pim_linear_mode="pim",
                               pim_block_mode="full")


def test_block_trace_respects_planner_coords():
    """Groups placed by the planner's placer hook keep their coordinates
    in the trace; cross-scope MOVs land between the placed banks."""
    eng = Engine(PORT[0])
    dev = DeviceConfig.parse("2x2x4x4", crossbar=eng.crossbar)
    plan = plan_block(_full_cfg(get_config), eng,
                      placer=CoordAllocator(dev).place)
    assert all(g.coord is not None for g in plan.groups)
    banks = [g.coord.bank for g in plan.groups]
    assert len(set(banks)) == len(banks)      # scope-aligned: new banks
    tr = block_trace(plan, dev)
    ats = [r.fields["at"] for r in tr.by_kind("EXEC")]
    assert ats == [str(g.coord) for g in plan.groups]
    assert len(tr.by_kind("BARRIER")) == len(plan.scopes)
    movs = tr.by_kind("MOV")
    assert len(movs) == len(plan.scopes) - 1
    assert charge(tr).hop_ns == sum(
        dev.hop_ns(Coord.parse(m.fields["src"]),
                   Coord.parse(m.fields["dst"])) for m in movs)


def test_block_trace_overflows_capacity():
    eng = Engine(PORT[0])
    dev = DeviceConfig.parse("1x1x1x1", crossbar=eng.crossbar)
    plan = plan_block(_full_cfg(get_config), eng)   # 3 groups, 1 crossbar
    with pytest.raises(DeviceCapacityError):
        block_trace(plan, dev)


@pytest.mark.parametrize("shape,tokens", [("2x2x4x4", 1), ("2x4x16x8", 3)])
def test_block_trace_charge_matches_reference(shape, tokens):
    """charge(block_trace(plan, dev)).as_dict() is the reference's, with
    each package's plan built from its own get_config and engine; the
    two traces dump to the same text."""
    eng = Engine(PORT[0])
    dev = DeviceConfig.parse(shape, crossbar=eng.crossbar)
    plan = plan_block(_full_cfg(get_config), eng,
                      placer=CoordAllocator(dev).place)
    tr = block_trace(plan, dev, tokens=tokens)
    jeng = JaxEngine()
    rdev = RefDeviceConfig.parse(shape, crossbar=jeng.crossbar)
    rplan = ref_plan_block(_full_cfg(ref_get_config), jeng,
                           placer=RefAllocator(rdev).place)
    rtr = ref_block_trace(rplan, rdev, tokens=tokens)
    assert tr.dumps() == rtr.dumps()
    got = charge(tr, tokens=tokens).as_dict()
    assert got == ref_charge(rtr, tokens=tokens).as_dict()
    assert got["latency_us"] > 0 and got["tokens_per_sec"] > 0


# ============================================================ configs ====
@pytest.mark.parametrize("arch", sorted(REF_ARCHS))
def test_configs_match_reference(arch):
    """The copied configs equal the reference's field for field, full
    size and smoke, with the same derived widths and parameter count."""
    assert sorted(ARCHS) == sorted(REF_ARCHS)
    for smoke in (False, True):
        got, ref = get_config(arch, smoke), ref_get_config(arch, smoke)
        assert dataclasses.asdict(got) == dataclasses.asdict(ref)
        assert (got.hd, got.q_dim, got.kv_dim) == (ref.hd, ref.q_dim,
                                                  ref.kv_dim)
        assert got.layer_kinds() == ref.layer_kinds()
        assert got.param_count() == ref.param_count()
        assert got.is_subquadratic == ref.is_subquadratic
    with pytest.raises(KeyError):
        get_config("no-such-arch")


def test_shape_cells_match_reference():
    from repro.configs import all_cells as ref_all_cells
    from repro_torch.configs import all_cells
    assert all_cells() == ref_all_cells()


# ====================================================== capacity/shed ====
def test_plan_block_sheds_on_capacity():
    cfg = dataclasses.replace(get_config("gemma2-9b", smoke=True),
                              pim_linear_mode="pim", pim_linear_bits=8,
                              pim_block_mode="full")
    eng = Engine(PORT[0])
    dev = DeviceConfig.parse("1x1x1x1")
    with pytest.raises(DeviceCapacityError):      # default policy raises
        plan_block(cfg, eng, placer=CoordAllocator(dev).place)
    before = obs.counter("plan.capacity_shed").value
    plan = plan_block(cfg, eng, placer=CoordAllocator(dev).place,
                      on_capacity="shed")
    assert len(plan.groups) == 1                  # head fits
    assert len(plan.shed) == 2                    # ffn + attn shed
    assert obs.counter("plan.capacity_shed").value - before == 2
    assert "SHED" in plan.summary()


def test_device_capacity_with_spares():
    rep = DeviceCostReport(device=DeviceConfig(), tokens=1,
                           crit_cycles=1000)
    base = rep.capacity(4 * rep.tokens_per_sec)
    assert base == 4
    assert rep.capacity(4 * rep.tokens_per_sec, spare_frac=0.25) == 6
    with pytest.raises(ValueError):
        rep.capacity(1.0, spare_frac=1.0)
