"""repro_torch.faults against the JAX package's repro.faults: fault
masks, the fault-injecting scan and the residue program bit for bit,
and the port's versions of tests/test_faults.py — resident detection and
replay, self-healing serve (quarantine, remap, shedding, watchdog) and
the retry policy — on ``torch:device=cpu,pack=true`` with the same
``faults.*`` and ``serve.*`` counters as the reference's runs."""
import dataclasses
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro import obs as jax_obs  # noqa: E402
from repro.compiler.cache import compile_cached as jax_compile  # noqa: E402
from repro.core.residue import residue_program as jax_residue  # noqa: E402
from repro.engine import Engine as JaxEngine  # noqa: E402
from repro.faults import FaultModel as JaxFaultModel  # noqa: E402
from repro.faults import get_fault_model as jax_get_fault_model  # noqa: E402
from repro.faults import pass_fault_tensors as jax_pass_fault_tensors  # noqa: E402
from repro.faults import register_fault_model as jax_register  # noqa: E402
from repro.kernels.ref import (  # noqa: E402
    crossbar_run_ref_packed_faulty as jax_faulty)
from repro.serve import TrafficConfig as JaxTrafficConfig  # noqa: E402
from repro.serve import generate as jax_generate  # noqa: E402
from repro.serve import run_load as jax_run_load  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.compiler.cache import compile_cached  # noqa: E402
from repro_torch.convert import words_to_numpy, words_to_torch  # noqa: E402
from repro_torch.core.bits import (pack_rows, to_bits,  # noqa: E402
                                   unpack_rows)
from repro_torch.core.executor import run_numpy  # noqa: E402
from repro_torch.core.residue import residue_program  # noqa: E402
from repro_torch.engine import Engine, resolve_backend  # noqa: E402
from repro_torch.engine.backends import (TorchBackend,  # noqa: E402
                                         backend_fault_model)
from repro_torch.faults import (FaultModel, RetryPolicy,  # noqa: E402
                                decode_residues, get_fault_model,
                                numpy_kernel_packed_faulty,
                                pass_fault_tensors, register_fault_model)
from repro_torch.kernels.ref import (  # noqa: E402
    crossbar_run_ref_packed_faulty)
from repro_torch.serve import TrafficConfig, generate, run_load  # noqa: E402

pytestmark = pytest.mark.system

PORT = "torch:device=cpu,pack=true"
KEYS = ["flip@0.003@5", "sa0@0.01@9"]
# What the counter comparisons read: detection, recovery and the serve
# layer's healing.
COUNTED = ("faults.", "serve.fault.", "serve.rejected", "serve.sched.")


def _counters(o):
    return dict(o.dump()["counters"])


def _deltas(o, before):
    now = _counters(o)
    return {k: now.get(k, 0) - before.get(k, 0) for k in now
            if k.startswith(COUNTED) and now.get(k, 0) != before.get(k, 0)}


def _reset(key):
    """Rewind the pass counter of ``key`` in both packages' registries
    (each registry shares one model per key across a process)."""
    get_fault_model(key).reset()
    jax_get_fault_model(key).reset()


def _register_both(**kw):
    register_fault_model(FaultModel(**kw))
    jax_register(JaxFaultModel(**kw))


# ------------------------------------------------- masks and the scan ----
@pytest.mark.parametrize("word_bits", [32, 64])
@pytest.mark.parametrize("key", KEYS)
def test_fault_tensors_identical_to_reference(key, word_bits):
    """pass_fault_tensors equals the reference's over several passes of
    one model, at 32- and 64-bit words (test_faults.py:40's masks)."""
    _reset(key)
    packed = compile_cached("multpim", 4).packed
    ref_packed = jax_compile("multpim", 4, verify=False).packed
    for rows in (96, 70, 1):
        mine = pass_fault_tensors(get_fault_model(key), packed, rows,
                                  word_bits)
        ref = jax_pass_fault_tensors(jax_get_fault_model(key), ref_packed,
                                     rows, word_bits)
        for a, b in zip(mine, ref):
            assert a.dtype == b.dtype and np.array_equal(a, b)
    assert get_fault_model(key)._passes == 3


@pytest.mark.parametrize("key", KEYS)
def test_fault_masks_bit_identical_across_backends(key):
    """test_faults.py:40: the same key gives the same corrupted outputs
    on the port's numpy (unpacked and packed) and torch backends and on
    the reference's numpy and jax backends."""
    n, rows = 4, 96
    rng = np.random.default_rng(2)
    batch = {"a": rng.integers(0, 1 << n, rows),
             "b": rng.integers(0, 1 << n, rows)}
    outs = []
    exe = Engine(PORT).compile("multpim", n)
    for spec in ("numpy:faults={k}", "numpy:pack=true,faults={k}",
                 PORT + ",faults={k}"):
        _reset(key)
        out = exe.run(batch, backend=spec.format(k=key))
        outs.append([int(v) for v in out["out"]])
    jexe = JaxEngine().compile("multpim", n)
    for spec in ("numpy:pack=true,faults={k}", "jax:pack=true,faults={k}"):
        _reset(key)
        out = jexe.run(batch, backend=spec.format(k=key))
        outs.append([int(v) for v in out["out"]])
    assert all(o == outs[0] for o in outs)
    if key.startswith("flip"):
        clean = exe.run(batch, backend="numpy")
        assert outs[0] != [int(v) for v in clean["out"]]


def test_faults_none_bit_identical_and_cache_keys_unchanged():
    """test_faults.py:62 on the torch backend."""
    eng = Engine(PORT)
    n, rows = 4, 32
    exe = eng.compile("multpim", n)
    rng = np.random.default_rng(3)
    batch = {"a": rng.integers(0, 1 << n, rows),
             "b": rng.integers(0, 1 << n, rows)}
    base = exe.run(batch)
    keys0 = set(eng.cache._entries)
    out = exe.run(batch, backend=PORT + ",faults=none")
    assert [int(v) for v in base["out"]] == [int(v) for v in out["out"]]
    assert set(eng.cache._entries) == keys0
    assert backend_fault_model(resolve_backend(PORT + ",faults=none")) \
        is None
    assert backend_fault_model(resolve_backend(PORT)) is None
    zeroed = "torch:device=cpu,pack=true,faults=flip@0@1"
    assert backend_fault_model(resolve_backend(zeroed)) is None


def test_faults_need_pack_on_torch():
    """Fault masks are packed words: the torch backend with pack=false
    raises under an active model, as the reference's jax backend does."""
    bk = TorchBackend(device="cpu", pack=False, faults="flip@0.01@1")
    packed = compile_cached("multpim", 4).packed
    with pytest.raises(ValueError, match="pack=true"):
        bk.run_state(packed, np.zeros((4, packed.init_mask.shape[1]),
                                      np.uint8))


@pytest.mark.parametrize("key", ["flip@0.002@3", "sa0@0.02@4",
                                 "sa1@0.02@6"])
@pytest.mark.parametrize("kind", ["multpim_mac", "stage", "recomb"])
def test_faulty_scan_matches_reference(kind, key):
    """The torch faulty scan equals the reference's jnp
    crossbar_run_ref_packed_faulty on the same state and masks, and the
    port's numpy twin at 64-bit words."""
    n, rows = 8, 70
    packed = compile_cached(kind, n).packed
    c = packed.init_mask.shape[1]
    rng = np.random.default_rng(5)
    state = rng.integers(0, 2, (rows, c), dtype=np.uint8)
    words = pack_rows(state, 32)
    for _ in range(2):                      # two successive states
        _reset(key)
        ref = np.array(jax_faulty(jnp.asarray(words),
                                  jax_compile(kind, n, verify=False).packed,
                                  jax_get_fault_model(key), rows))
        got = crossbar_run_ref_packed_faulty(
            words_to_torch(words), packed, get_fault_model(key), rows)
        assert np.array_equal(words_to_numpy(got), ref)
        _reset(key)
        flips, sa0, sa1 = pass_fault_tensors(get_fault_model(key), packed,
                                             rows, 64)
        st64 = numpy_kernel_packed_faulty(packed, pack_rows(state, 64),
                                          flips, sa0, sa1)
        assert np.array_equal(unpack_rows(st64, rows),
                              unpack_rows(ref, rows))
        words, state = ref, unpack_rows(ref, rows)


def test_faulty_scan_ands_every_write_of_a_cycle():
    """Two NOTs of one cycle writing one column leave the AND of both,
    under faults as in the fault-free plain versions."""
    from repro_torch.convert import packed_from_arrays
    gate = np.full((1, 2), 1, np.int32)
    ins = np.full((1, 2, 3), 3, np.int32)
    ins[0, :, 0] = [0, 1]
    packed = packed_from_arrays(gate, ins, np.array([[2, 2]], np.int32),
                                np.zeros((1, 4), bool))
    state = np.array([[0, 1, 1, 0], [1, 0, 1, 0], [0, 0, 1, 0],
                      [1, 1, 1, 0]], np.uint8)
    model = FaultModel(key="t-sa-none", p_sa1=1e-12)
    out = crossbar_run_ref_packed_faulty(words_to_torch(pack_rows(state, 32)),
                                         packed, model, 4)
    assert unpack_rows(words_to_numpy(out), 4)[:, 2].tolist() == [0, 0, 1, 0]


# --------------------------------------------------- model semantics ----
def test_fault_model_determinism_drift_and_pass_counter():
    """test_faults.py:82, and the port's draws equal the reference's."""
    m = FaultModel(key="t-det", seed=3, p_flip=0.01)
    jm = JaxFaultModel(key="t-det", seed=3, p_flip=0.01)
    a = m.flip_events(0, 40, 8, 64)
    assert all(np.array_equal(x, y) for x, y in
               zip(a, jm.flip_events(0, 40, 8, 64)))
    b = m.flip_events(0, 40, 8, 64)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    c = m.flip_events(1, 40, 8, 64)
    assert not all(np.array_equal(x, y) for x, y in zip(a, c))
    assert [m.next_pass() for _ in range(3)] == [0, 1, 2]
    m.reset()
    assert m.next_pass() == 0

    kw = dict(key="t-drift", seed=5, p_sa0=0.02, drift_every=4,
              drift_p=0.05, dead_rows=(2,))
    d, jd = FaultModel(**kw), JaxFaultModel(**kw)
    sa0_e0, sa1_e0 = d.stuck_bits(64, 10, epoch=0)
    sa0_e3, _ = d.stuck_bits(64, 10, epoch=3)
    assert np.array_equal(sa0_e3, jd.stuck_bits(64, 10, epoch=3)[0])
    assert np.array_equal(sa1_e0, jd.stuck_bits(64, 10, epoch=0)[1])
    assert np.all(sa0_e3[sa0_e0])
    assert sa0_e3.sum() > sa0_e0.sum()
    assert not np.any(sa1_e0 & sa0_e0)
    assert np.all(sa0_e0[2, :])
    assert d.epoch(0) == 0 and d.epoch(7) == 1 and d.epoch(8) == 2


def test_compact_spec_registry_shares_pass_counter():
    """test_faults.py:106: one model (one pass counter) per key in the
    port's registry, separate from the reference's."""
    m1 = get_fault_model("flip@0.5@77")
    m2 = get_fault_model("flip@0.5@77")
    assert m1 is m2
    assert m1 is not jax_get_fault_model("flip@0.5@77")
    assert (m1.key, m1.seed, m1.p_flip) == ("flip@0.5@77", 77, 0.5)
    assert get_fault_model("none") is None
    assert get_fault_model("") is None
    with pytest.raises(KeyError):
        get_fault_model("bogus@1")


# ---------------------------------------------------------- detection ----
@pytest.mark.parametrize("n", [4, 8, 16])
def test_residue_tables_identical(n):
    """The compiled residue program: the reference's tables and maps,
    and it passes its differential verification."""
    ref = jax_compile("residue", n, verify=False)
    got = compile_cached("residue", n)
    assert got.program.n_cycles == ref.program.n_cycles
    for name in ("gate_id", "in_cols", "out_col", "init_mask"):
        a, b = getattr(got.packed, name), getattr(ref.packed, name)
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    assert got.program.input_map == ref.program.input_map
    assert got.program.output_map == ref.program.output_map
    assert got.verified is not None and got.verified.ok
    assert residue_program(n).n_cycles == jax_residue(n).n_cycles


def test_residue_program_mod3_mod7():
    """test_faults.py:117."""
    n = 4
    prog = residue_program(n)
    rng = np.random.default_rng(4)
    sh = rng.integers(0, 1 << n, 32)
    ch = rng.integers(0, 1 << n, 32)
    lo = rng.integers(0, 1 << n, 32)
    out = run_numpy(prog, {"s_hi": to_bits(sh, n), "c_hi": to_bits(ch, n),
                           "lo": to_bits(lo, n)})
    r3, r7 = decode_residues(
        np.concatenate([out["r3"], out["r7"]], axis=1))
    want = (((sh + ch) % (1 << n)) << n) + lo
    assert np.array_equal(r3, want % 3)
    assert np.array_equal(r7, want % 7)


def test_resident_residue_on_torch_matches_numpy():
    """The torch chain's residue pass (K1's plain version here) reads
    the same planes as the numpy chain's."""
    planes = []
    for spec in ("numpy:pack=true", PORT):
        rng = np.random.default_rng(8)
        rex = Engine(spec).resident(8, rows=40, detect=True)
        for step in range(3):
            rex.step(rng.integers(0, 60, 40), rng.integers(0, 60, 40),
                     fresh=None if step == 0 else np.zeros(40, bool))
        planes.append(np.asarray(rex.chain.residue(rex._dev), np.uint8))
        assert not rex.unrecovered.any()
        assert [int(v) for v in rex.drain()] == [
            int(v) for v in rex.shadow.values()]
    assert np.array_equal(planes[0], planes[1])


def _chain(rex, seed, lo, hi, steps):
    """Step ``rex`` through ``steps`` seeded MAC passes; returns the
    exact accumulated values."""
    rng = np.random.default_rng(seed)
    shadow = np.zeros(rex.rows, dtype=object)
    for step in range(steps):
        a = rng.integers(lo, hi, rex.rows)
        b = rng.integers(lo, hi, rex.rows)
        rex.step(a, b, fresh=None if step == 0 else
                 np.zeros(rex.rows, dtype=bool))
        shadow += a.astype(object) * b.astype(object)
    return shadow


def test_resident_detects_and_replays_injected_corruption():
    """test_faults.py:135 on the torch backend: corruption of a lane's
    accumulator columns is caught at drain and repaired by replay, with
    the reference's counters for the same corruption."""
    ref = JaxEngine("numpy:pack=true").resident(8, rows=4, detect=True)
    _chain(ref, 6, 0, 40, 4)
    dev = np.asarray(ref._dev).copy()
    dev[0, list(ref.index.slo_cols)[:3]] ^= np.uint64(1 << 1)
    ref._dev = dev
    c0 = _counters(jax_obs)
    ref_got = [int(v) for v in ref.drain()]
    ref_d = _deltas(jax_obs, c0)

    rex = Engine(PORT).resident(8, rows=4, detect=True)
    shadow = _chain(rex, 6, 0, 40, 4)
    dev = rex._dev.clone()
    dev[0, list(rex.index.slo_cols)[:3]] ^= 1 << 1
    rex._dev = dev
    c0 = _counters(obs)
    got = [int(v) for v in rex.drain()]
    d = _deltas(obs, c0)
    assert got == [int(v) for v in shadow] == ref_got
    assert not rex.unrecovered.any()
    assert d.get("faults.detected", 0) >= 1
    assert d.get("faults.recovered", 0) >= 1
    assert d == ref_d
    assert rex.replayed_passes == ref.replayed_passes > 0


def test_resident_dead_row_flags_unrecovered_lane_only():
    """test_faults.py:162 on the torch backend, with the reference's
    counters and values."""
    _register_both(key="t-dead1", dead_rows=(2,))
    ref = JaxEngine("numpy:pack=true,faults=t-dead1").resident(8, rows=4)
    _chain(ref, 7, 1, 30, 3)
    c0 = _counters(jax_obs)
    ref_got = [int(v) for v in ref.drain()]
    ref_d = _deltas(jax_obs, c0)

    rex = Engine(PORT + ",faults=t-dead1").resident(8, rows=4)
    assert rex.detect
    shadow = _chain(rex, 7, 1, 30, 3)
    c0 = _counters(obs)
    got = [int(v) for v in rex.drain()]
    assert list(rex.unrecovered) == [False, False, True, False]
    for r in (0, 1, 3):
        assert got[r] == int(shadow[r])
    assert got == ref_got
    assert _deltas(obs, c0) == ref_d


# ------------------------------------------------- self-healing serve ----
def _traffic(n_requests=8, seed=0):
    return generate(TrafficConfig(n_requests=n_requests, rate=500.0,
                                  n_bits=8, seed=seed))


def _jax_traffic(n_requests=8, seed=0):
    return jax_generate(JaxTrafficConfig(n_requests=n_requests, rate=500.0,
                                         n_bits=8, seed=seed))


def _both(key, max_slots, n_requests=8):
    """One seeded trace through the reference (numpy:pack=true) and the
    port (torch on the CPU) under fault model ``key``: both reports and
    both counter deltas."""
    _reset(key)
    c0 = _counters(jax_obs)
    ref = jax_run_load(JaxEngine(f"numpy:pack=true,faults={key}"),
                       _jax_traffic(n_requests), max_slots=max_slots,
                       realtime=False)
    ref_d = _deltas(jax_obs, c0)
    c0 = _counters(obs)
    mine = run_load(Engine(f"{PORT},faults={key}"), _traffic(n_requests),
                    max_slots=max_slots, realtime=False)
    return ref, mine, ref_d, _deltas(obs, c0)


def test_serve_dead_lane_quarantined_and_remapped_bit_exact():
    """test_faults.py:187 on the torch backend, with the reference's
    counters."""
    _register_both(key="t-dead3", dead_rows=(3,))
    ref, rep, ref_d, d = _both("t-dead3", 8)
    assert rep.bit_exact and rep.escaped_tokens == 0
    assert rep.rejected == 0 and not rep.aborted
    assert rep.recompiles == 0
    assert d.get("serve.fault.quarantined", 0) >= 1
    assert d.get("serve.fault.restarts", 0) >= 1
    assert d == ref_d
    assert (rep.passes, rep.steps, rep.n_tokens) == (ref.passes, ref.steps,
                                                      ref.n_tokens)


def test_serve_all_lanes_dead_rejects_cleanly():
    """test_faults.py:202 on the torch backend, with the reference's
    counters."""
    _register_both(key="t-deadall", dead_rows=(0, 1, 2, 3))
    ref, rep, ref_d, d = _both("t-deadall", 4)
    assert rep.n_requests == 0
    assert rep.rejected == len(_traffic())
    assert not rep.aborted
    assert d.get("serve.rejected", 0) == rep.rejected
    assert d.get("serve.fault.quarantined", 0) == 4
    assert d == ref_d


def test_serve_transient_faults_recovered_bit_exact():
    """test_faults.py:217 on the torch backend: seeded flips detected,
    replay-recovered, tokens bit-exact, zero recompiles — and the same
    counters as the reference's run of the same key."""
    key = "flip@5e-5@0"
    ref, rep, ref_d, d = _both(key, 8, n_requests=12)
    assert rep.bit_exact and rep.escaped_tokens == 0
    assert rep.recompiles == 0
    assert d.get("faults.injected", 0) > 0
    assert d == ref_d


def test_serve_faults_roundtrip_checksum_matches_reference():
    """The round-trip substrate's mod-21 token checksum and restarts
    under flips: the reference's counters and tokens."""
    key = "flip@2e-4@1"
    _reset(key)
    c0 = _counters(jax_obs)
    ref = jax_run_load(JaxEngine(f"numpy:pack=true,faults={key}"),
                       _jax_traffic(6), mode="roundtrip", max_slots=4,
                       realtime=False)
    ref_d = _deltas(jax_obs, c0)
    c0 = _counters(obs)
    rep = run_load(Engine(f"{PORT},faults={key}"), _traffic(6),
                   mode="roundtrip", max_slots=4, realtime=False)
    assert _deltas(obs, c0) == ref_d
    assert (rep.bit_exact, rep.escaped_tokens, rep.passes) == (
        ref.bit_exact, ref.escaped_tokens, ref.passes)


def test_serve_watchdog_aborts_hung_backend():
    """test_faults.py:231 with a hanging torch backend."""
    @dataclasses.dataclass(frozen=True)
    class HangingBackend(TorchBackend):
        def run_state(self, *a, **kw):
            time.sleep(5.0)
            return super().run_state(*a, **kw)

    eng = Engine(HangingBackend(device="cpu"))
    c0 = _counters(obs)
    t0 = time.perf_counter()
    rep = run_load(eng, _traffic(2), mode="roundtrip", max_slots=2,
                   realtime=False, watchdog_s=0.5)
    assert rep.aborted
    assert time.perf_counter() - t0 < 4.0
    assert _counters(obs).get("serve.watchdog.aborts", 0) \
        - c0.get("serve.watchdog.aborts", 0) == 1


# ------------------------------------------------- retry unification ----
def test_retry_policy_bounded_and_counted():
    """test_faults.py:251."""
    p = RetryPolicy(max_retries=2, scope="t.retry")
    assert p.max_attempts == 3
    calls = {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] < 3:
            raise RuntimeError("boom")
        return "ok"

    def retries():
        return _counters(obs).get("t.retry.retries", 0)

    def exhausted():
        return _counters(obs).get("t.retry.exhausted", 0)

    r0 = retries()
    assert p.run(flaky) == "ok"
    assert calls["n"] == 3
    assert retries() - r0 == 2

    r0, e0 = retries(), exhausted()
    with pytest.raises(RuntimeError):
        p.run(lambda: (_ for _ in ()).throw(RuntimeError("always")))
    assert retries() - r0 == 2
    assert exhausted() - e0 == 1
    b = RetryPolicy(max_retries=3, backoff_s=0.5, backoff_mult=2.0)
    assert [b.delay_s(i) for i in range(3)] == [0.5, 1.0, 2.0]
    j = RetryPolicy(max_retries=3, backoff_s=0.5, jitter=0.2, seed=4)
    from repro.faults import RetryPolicy as JaxRetryPolicy
    jj = JaxRetryPolicy(max_retries=3, backoff_s=0.5, jitter=0.2, seed=4)
    assert [j.delay_s(i) for i in range(3)] == [jj.delay_s(i)
                                                for i in range(3)]
    with pytest.raises(ValueError):
        RetryPolicy(max_retries=-1)


def test_device_config_matches_reference():
    """The copied DeviceConfig, Coord and CoordAllocator (blocklist
    failover, capacity error) behave as the reference's."""
    from repro.device.config import CoordAllocator as JaxAllocator
    from repro.device.config import DeviceConfig as JaxDeviceConfig
    from repro_torch.device import (Coord, CoordAllocator,
                                    DeviceCapacityError, DeviceConfig)
    from repro_torch.pim import planner
    assert planner.DeviceCapacityError is DeviceCapacityError
    for spec in ("1x1x1x4", "2x4x16x8", "2x2x4x4"):
        d, jd = DeviceConfig.parse(spec), JaxDeviceConfig.parse(spec)
        assert (d.n_crossbars, d.n_banks, d.shape, str(d)) == (
            jd.n_crossbars, jd.n_banks, jd.shape, str(jd))
        assert [str(c) for c in d.coords()] == [str(c) for c in jd.coords()]
    assert DeviceConfig.parse("2x4x16x8").n_crossbars == 1024
    dev = DeviceConfig.parse("1x1x1x4")
    al, jal = CoordAllocator(dev), JaxAllocator(JaxDeviceConfig.parse(
        "1x1x1x4"))
    al.block("ch0.bg0.b0.x1")
    jal.block("ch0.bg0.b0.x1")
    assert [str(al.place(f"g{i}")) for i in range(3)] == [
        str(jal.place(f"g{i}")) for i in range(3)]
    with pytest.raises(DeviceCapacityError, match="1 blocked"):
        al.place("overflow")
    assert Coord.parse("ch1.bg0.b2.x3") == Coord(1, 0, 2, 3)
    with pytest.raises(ValueError):
        DeviceConfig.parse("2x2")
