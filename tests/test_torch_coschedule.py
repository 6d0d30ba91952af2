"""repro_torch co-scheduling against the JAX package's: the fused
K-program tables, BatchedExecutable/GroupedExecutable runs, the K-clamp
policy, the CapacityError fallback, and matvec's default co-scheduled
path (products and cycle counts), bit for bit on the CPU. The
reference runs on its numpy backend; the port on ``numpy`` and on the
torch backend's plain versions (``torch:device=cpu``)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.compiler.coschedule import (  # noqa: E402
    column_budget_counts as ref_column_budget_counts,
    coschedule as ref_coschedule)
from repro.engine import Engine as JaxEngine  # noqa: E402
from repro.engine import GroupSpec as JaxGroupSpec  # noqa: E402
from repro_torch.compiler import (CapacityError, PartitionAllocator,  # noqa: E402
                                  ProgramCache, column_budget_counts,
                                  coschedule)
from repro_torch.core.costmodel import CrossbarSpec  # noqa: E402
from repro_torch.core.matvec import multpim_mac  # noqa: E402
from repro_torch.engine import (BatchedExecutable, Engine,  # noqa: E402
                                GroupedExecutable, GroupSpec)

pytestmark = pytest.mark.core

PORT = ["torch:device=cpu,pack=true", "torch:device=cpu,pack=false", "numpy"]
GROUP = [("mac", 8, 2), ("multpim", 4), ("rime", 4, 1, "rime4")]


def _mac_bits(rng, rows, n):
    return {name: rng.integers(0, 2, (rows, n), dtype=np.uint8)
            for name in ("a", "b", "un", "s_lo", "c_lo", "c_lo_n")}


def _same_outputs(got, want, what):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert set(g) == set(w), what
        for name in w:
            np.testing.assert_array_equal(
                np.asarray(g[name], dtype=object),
                np.asarray(w[name], dtype=object),
                err_msg=f"{what} slot {i} output {name}")


def _same_tables(a, b):
    for name in ("gate_id", "in_cols", "out_col", "init_mask"):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name),
                                      err_msg=name)


# ---------------------------------------------------------- tables ----
@pytest.mark.parametrize("k", [2, 4])
def test_fused_tables_match_reference(k):
    """compile_batch fuses the same program: identical dense tables,
    placements and cycle count for k in {2, 4}."""
    bex = Engine("numpy").compile_batch("mac", 8, k)
    ref = JaxEngine().compile_batch("mac", 8, k)
    assert isinstance(bex, BatchedExecutable)
    assert bex.n_cycles == ref.n_cycles
    assert bex.program.name == ref.program.name
    assert [tuple(vars(p).values()) for p in bex.placements] == \
        [tuple(vars(p).values()) for p in ref.placements]
    _same_tables(bex.packed, ref.packed)


def test_group_tables_and_cost_rows_match_reference():
    gex = Engine("numpy").compile_group(
        [GroupSpec(*g[:3], label=g[3]) if len(g) > 3 else g for g in GROUP])
    ref = JaxEngine().compile_group(
        [JaxGroupSpec(*g[:3], label=g[3]) if len(g) > 3 else g
         for g in GROUP])
    assert isinstance(gex, GroupedExecutable) and gex.k == ref.k == 4
    _same_tables(gex.packed, ref.packed)
    assert gex.op_costs() == ref.op_costs()
    assert gex.cost().programs == 4
    assert gex.cost().cycles == ref.cost().cycles


def test_coschedule_module_matches_reference():
    """The copied coschedule over the port's own builders yields the
    reference's placements, cycle count, and column budget counts."""
    from repro.core.matvec import multpim_mac as ref_mac
    for k in (2, 3):
        fused, pl = coschedule([multpim_mac(4)] * k)
        rfused, rpl = ref_coschedule([ref_mac(4)] * k)
        assert fused.n_cycles == rfused.n_cycles
        assert fused.layout.n_cols == rfused.layout.n_cols
        assert [vars(p) for p in pl] == [vars(p) for p in rpl]
        fused.validate()
    progs = [multpim_mac(4), multpim_mac(8)]
    rprogs = [ref_mac(4), ref_mac(8)]
    for cols, weights in ((1024, None), (1024, [1.0, 3.0]), (None, None)):
        assert column_budget_counts(progs, cols, weights=weights) == \
            ref_column_budget_counts(rprogs, cols, weights=weights)
    prog = multpim_mac(4)
    alloc = PartitionAllocator(max_cols=2 * prog.layout.n_cols + 1)
    assert alloc.capacity(prog) == 2
    with pytest.raises(CapacityError):
        coschedule([prog] * 3, allocator=PartitionAllocator(
            max_cols=2 * prog.layout.n_cols + 1))


# -------------------------------------------------------------- runs ----
@pytest.mark.parametrize("backend", PORT)
def test_compile_batch_parity(backend):
    """K co-scheduled MACs on the port == the reference's fused pass on
    its numpy backend == K independent runs."""
    k, n, rows = 3, 8, 16
    rng = np.random.default_rng(42)
    groups = [_mac_bits(rng, rows, n) for _ in range(k)]
    eng = Engine(backend)
    got = eng.compile_batch("mac", n, k).run(groups)
    want = JaxEngine().compile_batch("mac", n, k).run(groups,
                                                       backend="numpy")
    _same_outputs(got, want, backend)
    exe = eng.compile("mac", n)
    _same_outputs(got, [exe.run(g) for g in groups], f"{backend} single")


@pytest.mark.parametrize("backend", PORT)
def test_compile_group_parity(backend):
    """A heterogeneous group (two MACs, a multiplier, a RIME multiplier)
    on the port == the reference's group on its numpy backend."""
    rng = np.random.default_rng(7)
    rows = 6
    macs = [_mac_bits(rng, rows, 8) for _ in range(2)]
    mul = {"a": rng.integers(0, 16, rows), "b": rng.integers(0, 16, rows)}
    rim = {"a": rng.integers(0, 16, rows), "b": rng.integers(0, 16, rows)}
    gex = Engine(backend).compile_group(
        [GroupSpec(*g[:3], label=g[3]) if len(g) > 3 else g for g in GROUP])
    ref = JaxEngine().compile_group(
        [JaxGroupSpec(*g[:3], label=g[3]) if len(g) > 3 else g
         for g in GROUP])
    got = gex.run(macs + [mul, rim])
    want = ref.run(macs + [mul, rim], backend="numpy")
    _same_outputs(got, want, backend)
    assert [int(v) for v in got[2]["out"]] == [
        int(p) * int(q) for p, q in zip(mul["a"], mul["b"])]


@pytest.mark.parametrize("backend", PORT[:2])
def test_packed_group_and_batch_parity(backend):
    """The reference's packed-backend checks (MAC inputs marshalled by
    the engine, 33 and 40 rows: not multiples of the 32-row word)."""
    rng = np.random.default_rng(11)
    eng = Engine(backend)
    jeng = JaxEngine()
    group = []
    for _ in range(2):
        a = rng.integers(0, 16, 33)
        x = rng.integers(0, 16, 33)
        group.append(eng.mac_inputs(4, a, x, np.zeros(33, object),
                                    np.zeros(33, object)))
    _same_outputs(eng.compile_batch("mac", 4, 2).run(group),
                  jeng.compile_batch("mac", 4, 2).run(group,
                                                      backend="numpy"),
                  backend)
    a = rng.integers(0, 16, 40)
    x = rng.integers(0, 16, 40)
    mac_in = eng.mac_inputs(4, a, x, np.zeros(40, object),
                            np.zeros(40, object))
    mul_in = {"a": rng.integers(0, 16, 40), "b": rng.integers(0, 16, 40)}
    _same_outputs(
        eng.compile_group([("mac", 4, 1), ("multpim", 4)]).run(
            [mac_in, mul_in]),
        jeng.compile_group([("mac", 4, 1), ("multpim", 4)]).run(
            [mac_in, mul_in], backend="numpy"), backend)


def test_batched_mixed_marshalling_and_errors():
    """An integer group gets integers back next to a bit-plane group;
    wrong K, missing inputs and oversized K raise as in the reference."""
    eng = Engine(PORT[0])
    n = 4
    bex = eng.compile_batch("multpim", n, 2)
    exe = eng.compile("multpim", n)
    rng = np.random.default_rng(5)
    ints = {"a": rng.integers(0, 1 << n, 6), "b": rng.integers(0, 1 << n, 6)}
    planes = {"a": rng.integers(0, 2, (6, n), dtype=np.uint8),
              "b": rng.integers(0, 2, (6, n), dtype=np.uint8)}
    got = bex.run([ints, planes])
    _same_outputs(got, [exe.run(ints), exe.run(planes)], "mixed")
    assert got[1]["out"].shape == (6, 2 * n)
    mac = eng.compile_batch("mac", 4, 2)
    with pytest.raises(ValueError):
        mac.run([_mac_bits(rng, 4, 4)])
    with pytest.raises(KeyError):
        mac.run([{"a": [1]}, {"a": [1]}])
    with pytest.raises(CapacityError):
        eng.compile_batch("mac", 8, 100)


def test_fused_entry_memo_and_refresh():
    """The fused entry is memoized per (OpSpec, k) and rebuilt when the
    program cache recompiles the base entry."""
    eng = Engine(PORT[0])
    b1 = eng.compile_batch("mac", 8, 2)
    assert eng.compile_batch("mac", 8, 2).inner.packed is b1.inner.packed
    assert eng.compile_batch("mac", 8, 3).inner.packed is not \
        b1.inner.packed
    cache = ProgramCache()
    eng = Engine(PORT[0], cache=cache)
    b1 = eng.compile_batch("mac", 4, 2)
    cache.clear()
    b2 = eng.compile_batch("mac", 4, 2)
    assert b2.base_entry is not b1.base_entry
    assert b2.inner.entry is not b1.inner.entry
    rng = np.random.default_rng(0)
    groups = [_mac_bits(rng, 4, 4) for _ in range(2)]
    _same_outputs(b1.run(groups), b2.run(groups), "refresh")


# ------------------------------------------------------------ policy ----
def test_policy_surface_matches_reference():
    eng, ref = Engine(PORT[0]), JaxEngine()
    for n in (4, 8, 16):
        assert eng.max_coschedule_k("mac", n) == ref.max_coschedule_k("mac",
                                                                      n)
        assert eng.k_ladder("mac", n) == ref.k_ladder("mac", n)
        assert eng.k_ladder("mac", n, max_k=3) == ref.k_ladder("mac", n,
                                                               max_k=3)
        assert eng.effective_coschedule_k("mac", n) == \
            ref.effective_coschedule_k("mac", n)
    specs = [("mac", 8), ("mac", 8), ("mac", 16)]
    for weights in (None, [1.0, 2.0, 4.0]):
        assert eng.group_counts(specs, weights=weights) == \
            ref.group_counts(specs, weights=weights)
    assert eng.effective_coschedule_k("mac", 8) == 4    # the linear path


def test_capacity_error_fallback():
    """A MAC too wide for one crossbar copy: max_coschedule_k is 0, the
    default paths fall back to the plain compile (linear and matvec do
    not raise; matvec equals the reference), an explicit K raises."""
    one_cols = Engine(PORT[0]).compile("mac", 8).program.layout.n_cols
    tiny = Engine(PORT[0], crossbar=CrossbarSpec(cols=one_cols - 1))
    assert tiny.max_coschedule_k("mac", 8) == 0
    tiny.linear(torch.ones(2, 4), torch.ones(4, 3), n_bits=8, mode="pim")
    tiny.ragged_linear(torch.ones(2, 4), torch.ones(1, 4, 3), [2],
                       n_bits=8, mode="pim")
    rng = np.random.default_rng(0)
    A = rng.integers(0, 50, (2, 3))
    v = rng.integers(0, 50, 3)
    from repro.core.costmodel import CrossbarSpec as JaxCrossbarSpec
    ref = JaxEngine(crossbar=JaxCrossbarSpec(cols=one_cols - 1))
    res, cyc = tiny.matvec(A, v, 8)
    rres, rcyc = ref.matvec(A, v, 8)
    assert [int(r) for r in res] == [int(r) for r in rres] == \
        [int(w) for w in (A.astype(object) @ v.astype(object))]
    assert cyc == rcyc
    with pytest.raises(CapacityError):
        tiny.compile_batch("mac", 8, 2)


# ------------------------------------------------------------ matvec ----
@pytest.mark.parametrize("n,e", [(8, 8), (8, 5), (16, 9)])
def test_matvec_default_k_matches_reference(n, e):
    """The repaired default: matvec with no k follows the engine policy
    (co-scheduled, k = min(coschedule_k, E)), returning the reference's
    products and cycle count, cheaper than the k=1 chain."""
    rng = np.random.default_rng(n * e)
    A = rng.integers(0, 1 << (n - 2), (5, e))
    x = rng.integers(0, 1 << (n - 2), e)
    eng = Engine(PORT[0])
    res, cyc = eng.matvec(A, x, n)
    rres, rcyc = JaxEngine().matvec(A, x, n)
    mask = (1 << (2 * n)) - 1
    want = [int(w) & mask for w in A.astype(object) @ x.astype(object)]
    assert [int(r) for r in res] == [int(r) for r in rres] == want
    assert cyc == rcyc
    _, cyc_seq = eng.matvec(A, x, n, k=1)
    assert cyc < cyc_seq


@pytest.mark.parametrize("k", [2, 3, 4])
def test_inner_product_explicit_k_matches_reference(k):
    """inner_product(k > 1) on both torch:cpu layouts == the reference,
    products and cycles; resident=True with k > 1 is refused."""
    rng = np.random.default_rng(k)
    a = rng.integers(0, 1 << 6, (4, 7))
    x = rng.integers(0, 1 << 6, (4, 7))
    rres, rcyc = JaxEngine().inner_product(a, x, 8, k=k)
    for bk in PORT[:2]:
        res, cyc = Engine(bk).inner_product(a, x, 8, k=k)
        assert [int(r) for r in res] == [int(r) for r in rres], bk
        assert cyc == rcyc, bk
    with pytest.raises(ValueError, match="k=1"):
        Engine(PORT[0]).inner_product(a, x, 8, k=k, resident=True)
