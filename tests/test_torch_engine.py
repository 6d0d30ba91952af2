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
    TorchBackend, resolve_backend, supports_resident)
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
    with pytest.raises(NotImplementedError, match="faults"):
        resolve_backend("torch:device=cpu,faults=flip@1e-3")
    assert resolve_backend("torch:device=cpu,faults=none").faults == "none"


def test_unported_paths_raise_not_implemented():
    """Fault detection and injection are the paths still to port; the
    co-scheduling and PIM-linear paths have their parity tests in
    tests/test_torch_coschedule.py and tests/test_torch_pim.py."""
    eng = Engine(PORT[0])
    with pytest.raises(NotImplementedError, match="faults"):
        eng.resident(8, rows=4, detect=True)
    with pytest.raises(NotImplementedError, match="faults"):
        resolve_backend("torch:device=cpu,faults=sa0@1e-3")
