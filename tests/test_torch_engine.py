"""repro_torch engine: the port's Executable.run (packed and unpacked)
and its device-resident MAC chain against the JAX package's engine on
the numpy, jax:pack=true and pallas:pack=true (interpret) backends, bit
for bit, on the CPU (``torch:device=cpu`` runs the kernels' plain
versions)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.engine import Engine as JaxEngine  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.engine import Engine  # noqa: E402
from repro_torch.engine.backends import (  # noqa: E402
    TorchBackend, backend_fault_model, resolve_backend, supports_resident)
from repro_torch.kernels.ref import crossbar_run_ref_packed  # noqa: E402

pytestmark = pytest.mark.core

PORT = ["torch:device=cpu,pack=true", "torch:device=cpu,pack=false"]
# The reference's packed paths at fusion depth 1: its own tests hold
# every depth equal, and depth 1 keeps the jit/interpret traces small.
REFERENCE = ["numpy", "jax:pack=true,macro=1", "pallas:pack=true,macro=1"]


def _mask(n):
    return (1 << n) - 1


@pytest.fixture()
def tracer():
    t = obs.get_tracer()
    t.reset()
    t.enable()
    yield t
    t.disable()
    t.reset()


# ------------------------------------------------- multiplier parity ----
@pytest.mark.parametrize("n", [4, 8, 16])
@pytest.mark.parametrize("op", ["multpim", "rime"])
def test_multiplier_parity(op, n):
    """Executable.run on the port (packed and unpacked) equals the
    reference engine on every reference backend and the exact product."""
    rng = np.random.default_rng(n)
    a = rng.integers(0, 1 << n, 16)
    b = rng.integers(0, 1 << n, 16)
    want = [(int(x) * int(y)) & _mask(2 * n) for x, y in zip(a, b)]
    jexe = JaxEngine().compile(op, n)
    for bk in REFERENCE:
        assert [int(v) for v in jexe.run({"a": a, "b": b},
                                         backend=bk)["out"]] == want, bk
    exe = Engine(PORT[0]).compile(op, n)
    for bk in PORT:
        assert [int(v) for v in exe.run({"a": a, "b": b},
                                        backend=bk)["out"]] == want, bk
    # bit-plane inputs come back as identical bit planes
    from repro.core.bits import to_bits
    planes = {"a": to_bits(a, n), "b": to_bits(b, n)}
    ref_bits = jexe.run(planes, backend="numpy")["out"]
    for bk in PORT:
        assert np.array_equal(exe.run(planes, backend=bk)["out"], ref_bits)


@pytest.mark.parametrize("n", [4, 8, 16])
def test_mac_parity(n):
    """The Section-VI MAC: identical (lo, s_hi, c_hi) to the reference on
    every backend, and the carry-save sum is the exact MAC."""
    rng = np.random.default_rng(7 * n)
    a = rng.integers(0, 1 << n, 8)
    b = rng.integers(0, 1 << n, 8)
    s = rng.integers(0, 1 << (2 * n - 2), 8)
    c = rng.integers(0, 1 << (2 * n - 2), 8)
    jeng = JaxEngine()
    ref = [jeng.mac(a, b, s, c, n, backend=bk) for bk in REFERENCE]
    eng = Engine(PORT[0])
    got = [eng.mac(a, b, s, c, n, backend=bk) for bk in PORT]
    want0 = [[int(v) for v in part] for part in ref[0]]
    for res in ref + got:
        assert [[int(v) for v in part] for part in res] == want0
    lo, sh, ch = got[0]
    for x, y, si, ci, l, s2, c2 in zip(a, b, s, c, lo, sh, ch):
        want = (int(x) * int(y) + int(si) + int(ci)) & _mask(2 * n)
        assert (int(l) + ((int(s2) + int(c2)) << n)) & _mask(2 * n) == want


# ------------------------------------------------------- resident ----
@pytest.mark.parametrize("n", [8, 16])
def test_inner_product_resident_matches_reference(n):
    """The port's resident inner product equals its own round trip, the
    reference engine's resident chains and the exact sums."""
    rng = np.random.default_rng(3 + n)
    rows, E = 6, 7
    a = rng.integers(0, 50, (rows, E))
    x = rng.integers(0, 50, (rows, E))
    want = [int(sum(int(ai) * int(xi) for ai, xi in zip(ar, xr)))
            for ar, xr in zip(a, x)]
    eng = Engine(PORT[0])
    res, cyc = eng.inner_product(a, x, n, k=1, resident=True)
    rt, cyc_rt = eng.inner_product(a, x, n, k=1, resident=False)
    assert [int(v) for v in res] == want
    assert [int(v) for v in rt] == want
    assert cyc == cyc_rt
    for bk in ["numpy:pack=true"] + REFERENCE[1:]:
        jres, jcyc = JaxEngine(bk).inner_product(a, x, n, k=1,
                                                  resident=True)
        assert [int(v) for v in jres] == want, bk
        assert jcyc == cyc, bk


def test_matvec_resident_matches_reference():
    rng = np.random.default_rng(4)
    A = rng.integers(0, 50, (5, 4))
    x = rng.integers(0, 50, 4)
    want = [int(w) for w in A.astype(object) @ x.astype(object)]
    eng = Engine(PORT[0])
    res, cyc = eng.matvec(A, x, 8, k=1, resident=True)
    rt, _ = eng.matvec(A, x, 8, k=1, resident=False)
    jres, jcyc = JaxEngine(REFERENCE[1]).matvec(A, x, 8, k=1,
                                                  resident=True)
    assert [int(v) for v in res] == want
    assert [int(v) for v in rt] == want
    assert [int(v) for v in jres] == want and jcyc == cyc


def test_resident_fresh_mask_restarts_lanes_mid_chain():
    """Fresh lanes restart while neighbours keep accumulating; drains are
    non-destructive. Every drain equals the reference chain's under the
    same masks and a plain-int shadow."""
    n, rows = 8, 4
    rex = Engine(PORT[0]).resident(n, rows=rows)
    jrex = JaxEngine(REFERENCE[1]).resident(n, rows=rows)
    rng = np.random.default_rng(5)
    shadow = [0] * rows
    for step in range(6):
        a = rng.integers(0, 40, rows)
        b = rng.integers(0, 40, rows)
        fresh = np.zeros(rows, dtype=bool)
        if step:
            fresh[step % rows] = True
        for r in range(rows):
            if fresh[r] or step == 0:
                shadow[r] = 0
            shadow[r] = (shadow[r] + int(a[r]) * int(b[r])) & _mask(2 * n)
        rex.step(a, b, fresh=None if step == 0 else fresh)
        jrex.step(a, b, fresh=None if step == 0 else fresh)
        got = [int(v) for v in rex.drain()]
        assert got == shadow, f"lane state diverged at step {step}"
        assert got == [int(v) for v in jrex.drain()]


def test_resident_chain_never_unpacks_between_passes(tracer):
    """State stays on the device for the whole chain: exactly one
    backend.unpack (at the drain), no marshal/unmarshal."""
    rex = Engine(PORT[0]).resident(8, rows=4)
    tracer.reset()
    rng = np.random.default_rng(6)
    E = 5
    for _ in range(E):
        rex.step(rng.integers(0, 40, 4), rng.integers(0, 40, 4))
    rex.drain()
    names = [e["name"] for e in tracer.trace_dict()["traceEvents"]
             if e.get("ph") == "X"]
    assert names.count("backend.unpack") == 1, names
    assert "exec.marshal" not in names and "exec.unmarshal" not in names
    assert names.count("exec.step") == E - 1
    assert names.count("exec.load") == 1
    assert names.count("exec.drain") == 1


@pytest.mark.parametrize("E", [1, 2, 5])
def test_resident_chain_packed_pass_count(E):
    """One packed pass per program run: mac first, stage + mac per later
    step, recomb at the drain — 1 + 2(E-1) + 1 (the plain version's
    count on the CPU, K1's launch count on a card)."""
    eng = Engine(PORT[0])
    a = np.arange(3 * E).reshape(3, E) % 7
    eng.inner_product(a, a, 8, k=1, resident=True)     # build the chain
    crossbar_run_ref_packed.calls = 0
    res, _ = eng.inner_product(a, a, 8, k=1, resident=True)
    assert crossbar_run_ref_packed.calls == 1 + 2 * (E - 1) + 1
    assert [int(v) for v in res] == [int((r * r).sum()) for r in a]


# ---------------------------------------------------- backend policy ----
def test_torch_backend_policy():
    bk = resolve_backend("torch:device=cpu,pack=true,macro=3,row_block=64")
    assert isinstance(bk, TorchBackend)
    assert (bk.device, bk.pack, bk.macro, bk.word_block) == ("cpu", True,
                                                             3, 2)
    assert supports_resident(bk)
    assert not supports_resident(resolve_backend("torch:device=cpu,"
                                                 "pack=false"))
    with pytest.raises(ValueError, match="resident"):
        Engine("torch:device=cpu,pack=false").resident(8, rows=4)
    exe = Engine(PORT[0]).compile("multpim", 4)
    assert exe.cost().pack and exe.cost().cycles == exe.n_cycles
    flips = resolve_backend("torch:device=cpu,faults=flip@1e-3")
    assert backend_fault_model(flips).p_flip == 1e-3
    assert resolve_backend("torch:device=cpu,faults=none").faults == "none"
    assert backend_fault_model(
        resolve_backend("torch:device=cpu,faults=none")) is None
    with pytest.raises(ValueError, match="pack=true"):
        Engine("torch:device=cpu,pack=false,faults=flip@1e-3").compile(
            "multpim", 4).run({"a": [3], "b": [5]})


def test_detect_and_fault_paths_run():
    """Drain-time fault detection and fault injection run on the torch
    backend; their parity tests are in tests/test_torch_faults.py."""
    eng = Engine(PORT[0])
    rex = eng.resident(8, rows=4, detect=True)
    assert rex.detect and rex.residue_entry is not None
    rex.step([1, 2, 3, 4], [5, 6, 7, 8])
    assert [int(v) for v in rex.drain()] == [5, 12, 21, 32]
    assert not rex.unrecovered.any()
    assert not eng.resident(8, rows=4).detect
    bk = resolve_backend("torch:device=cpu,faults=sa0@1e-3")
    assert backend_fault_model(bk).p_sa0 == 1e-3
    assert eng.resident(8, rows=4, backend=bk).detect


# ----------------------------------- resident programs and marshalling ----
# The counterparts of tests/test_resident.py's program-truth and MAC
# marshalling tests, on Engine("torch:device=cpu"), each also held
# against the reference engine's own outputs.
@pytest.mark.parametrize("n", [4, 8])
def test_stage_program_truth(n):
    """stage: (s_hi, c_hi, lo) -> un = NOT((s_hi+c_hi) mod 2^n) and
    s_lo = lo, on the port and equal to the reference's pass."""
    rng = np.random.default_rng(0)
    hi = 1 << n
    feed = {k: rng.integers(0, hi, 32) for k in ("s_hi", "c_hi", "lo")}
    out = Engine(PORT[0]).compile("stage", n).run(feed)
    ref = JaxEngine().compile("stage", n).run(feed)
    want_un = [(hi - 1) ^ ((int(s) + int(c)) & (hi - 1))
               for s, c in zip(feed["s_hi"], feed["c_hi"])]
    assert [int(u) for u in out["un"]] == want_un
    assert [int(v) for v in out["s_lo"]] == [int(v) for v in feed["lo"]]
    for k in ("un", "s_lo"):
        assert [int(v) for v in out[k]] == [int(v) for v in ref[k]]


@pytest.mark.parametrize("n", [4, 8])
def test_recomb_program_truth(n):
    """recomb: the drained token is lo + (((s_hi+c_hi) mod 2^n) << n),
    on the port and equal to the reference's pass."""
    rng = np.random.default_rng(1)
    hi = 1 << n
    feed = {k: rng.integers(0, hi, 32) for k in ("s_hi", "c_hi", "lo")}
    out = Engine(PORT[0]).compile("recomb", n).run(feed)
    ref = JaxEngine().compile("recomb", n).run(feed)
    want = [int(lo) + (((int(s) + int(c)) & (hi - 1)) << n)
            for lo, s, c in zip(feed["lo"], feed["s_hi"], feed["c_hi"])]
    assert [int(v) for v in out["out"]] == want
    assert [int(v) for v in ref["out"]] == want


def test_mac_inputs_vectorized_matches_exact_planes():
    """The int64 fast path (n <= 30) emits exactly the planes the
    object-int definition specifies (the complemented u-stream and
    carry-low planes included), and the reference's planes."""
    from repro.core.bits import to_bits
    eng = Engine(PORT[0])
    n = 8
    rng = np.random.default_rng(7)
    rows = 16
    a = rng.integers(0, 1 << n, rows)
    b = rng.integers(0, 1 << n, rows)
    s = rng.integers(0, 1 << (2 * n - 1), rows)
    c = rng.integers(0, 1 << (2 * n - 1), rows)
    got = eng.mac_inputs(n, a, b, s, c)
    m = (1 << n) - 1
    u = np.array([(int(si) >> n) + (int(ci) >> n)
                  for si, ci in zip(s, c)], dtype=object)
    assert np.array_equal(got["a"], to_bits(a.astype(object), n))
    assert np.array_equal(got["b"], to_bits(b.astype(object), n))
    assert np.array_equal(got["un"], 1 - to_bits(u, n))
    assert np.array_equal(got["s_lo"], to_bits([int(v) & m for v in s], n))
    assert np.array_equal(got["c_lo"], to_bits([int(v) & m for v in c], n))
    assert np.array_equal(got["c_lo_n"], 1 - got["c_lo"])
    for v in got.values():
        assert v.dtype == np.uint8 or v.max() <= 1
    ref = JaxEngine().mac_inputs(n, a, b, s, c)
    assert set(ref) == set(got)
    for k in ref:
        assert np.array_equal(np.asarray(got[k]), np.asarray(ref[k])), k


def test_mac_inputs_wide_object_path_matches_fast_path_semantics():
    """n > 30 falls back to exact object ints; mac_inputs -> compiled mac
    -> mac_accumulate stays exact at both widths, and equals the
    reference's round trip."""
    eng = Engine(PORT[0])
    ref = JaxEngine()
    for n in (8, 32):
        rng = np.random.default_rng(n)
        hi = 1 << min(16, n)
        a = np.array([int(v) for v in rng.integers(0, hi, 4)], dtype=object)
        b = np.array([int(v) for v in rng.integers(0, hi, 4)], dtype=object)
        z = np.zeros(4, dtype=object)
        s, c = eng.mac_accumulate(n, eng.compile("mac", n).run(
            eng.mac_inputs(n, a, b, z, z)))
        assert [int(si) + int(ci) for si, ci in zip(s, c)] \
            == [int(x) * int(y) for x, y in zip(a, b)]
        rs, rc = ref.mac_accumulate(n, ref.compile("mac", n).run(
            ref.mac_inputs(n, a, b, z, z)))
        assert [int(v) for v in s] == [int(v) for v in rs]
        assert [int(v) for v in c] == [int(v) for v in rc]


def test_mac_inputs_overflow_raises_on_both_paths():
    """A u-stream past 2^n raises OverflowError on the fast path (n = 8)
    and the object path (n = 31), as the reference's does."""
    for eng in (Engine(PORT[0]), JaxEngine()):
        bad = np.array([1 << 15], dtype=object)   # u-stream > 2^8
        with pytest.raises(OverflowError):
            eng.mac_inputs(8, [1], [1], bad, bad)
        with pytest.raises(OverflowError):
            eng.mac_inputs(31, [1], [1], [1 << 61], [1 << 61])


def test_mac_accumulate_vectorized_matches_object_path():
    """``_mac_accumulate`` on random planes: s = lo + (s_hi << n), c =
    c_hi << n as object ints, equal to the reference's."""
    from repro.core.bits import from_bits
    rng = np.random.default_rng(9)
    n, rows = 8, 12
    out = {k: rng.integers(0, 2, (rows, n)).astype(np.uint8)
           for k in ("lo", "s_hi", "c_hi")}
    s, c = Engine._mac_accumulate(n, out)
    lo, s_hi, c_hi = (from_bits(out["lo"]), from_bits(out["s_hi"]),
                      from_bits(out["c_hi"]))
    assert [int(v) for v in s] == [
        int(lo_) + (int(sh) << n) for lo_, sh in zip(lo, s_hi)]
    assert [int(v) for v in c] == [int(ch) << n for ch in c_hi]
    assert s.dtype == object and c.dtype == object
    rs, rc = JaxEngine._mac_accumulate(n, out)
    assert [int(v) for v in s] == [int(v) for v in rs]
    assert [int(v) for v in c] == [int(v) for v in rc]
