"""repro_torch kernels: the plain versions of K1 (packed) and K2
(unpacked) against the JAX package's Pallas kernels (interpret mode) and
its jnp references, bit for bit, on tables compiled by the JAX package
and carried over with ``repro_torch.convert``. The kernels themselves
are held against these plain versions on a card in
``tests/test_torch_cuda.py`` and ``chip_smoke.py``."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.compiler.cache import compile_cached  # noqa: E402
from repro.core.bits import pack_rows, unpack_rows  # noqa: E402
from repro.core.executor import PackedProgram, pack_program  # noqa: E402
from repro.core.isa import GATE_ARITY, Gate, Op, eval_gate  # noqa: E402
from repro.core.program import Layout, ProgramBuilder  # noqa: E402
from repro.kernels.crossbar_step import (  # noqa: E402
    crossbar_run_pallas, crossbar_run_pallas_packed)
from repro.kernels.ref import (  # noqa: E402
    crossbar_run_ref as jax_run_ref,
    crossbar_run_ref_packed as jax_run_ref_packed)
from repro_torch.convert import (  # noqa: E402
    packed_from_arrays, words_to_numpy, words_to_torch)
from repro_torch.kernels.crossbar_step import (  # noqa: E402
    command_stream, crossbar_run, crossbar_run_packed, decode_records,
    encode_records, kernel_tables)
from repro_torch.kernels.ref import (  # noqa: E402
    crossbar_run_ref, crossbar_run_ref_packed)
from _tables import dup_write_table, random_dup_table  # noqa: E402

pytestmark = pytest.mark.kernels


def _port(jp):
    """The JAX package's packed tables as the port's PackedProgram."""
    return packed_from_arrays(jp.gate_id, jp.in_cols, jp.out_col,
                              jp.init_mask)


def _k1_all(words: np.ndarray, jp, macro: int):
    """(port twin, port wrapper on CPU, jax ref, pallas interpret) words.
    The port runs at fusion depth ``macro``; the references at depth 1
    (their own tests hold every depth equal, and depth 1 keeps their
    trace small)."""
    pp = _port(jp)
    twin = words_to_numpy(crossbar_run_ref_packed(
        words_to_torch(words), pp, macro=macro))
    wrap = words_to_numpy(crossbar_run_packed(
        words_to_torch(words), pp, macro=macro))
    ref = np.asarray(jax_run_ref_packed(jnp.asarray(words), jp, macro=1))
    pal = np.asarray(crossbar_run_pallas_packed(
        jnp.asarray(words), jp, macro=1, interpret=True))
    return twin, wrap, ref, pal


def _gate_program(gate: Gate):
    lay = Layout()
    p = lay.new_partition()
    xs = [lay.add_cell(p, f"x{i}") for i in range(3)]
    out = lay.add_cell(p, "y")
    b = ProgramBuilder(lay, name=f"gate-{gate.name}")
    for i, c in enumerate(xs):
        b.declare_input(f"x{i}", [c])
    b.declare_output("y", [out])
    b.init([out])
    arity = GATE_ARITY[gate]
    b.cycle([Op(gate, tuple(xs[:arity]) or (xs[0],), out)])
    return b.build(validate=False)


# ----------------------------------------------------------------- K1 ----
@pytest.mark.parametrize("gate", [Gate.NOT, Gate.NOR, Gate.MIN3,
                                  Gate.NAND, Gate.OR, Gate.COPY])
def test_k1_plain_every_gate(gate):
    """All 8 input combinations over a ragged 70-row batch: the port's
    packed plain version equals the JAX reference, the Pallas kernel and
    the gate's truth table."""
    prog = _gate_program(gate)
    jp = pack_program(prog)
    combos = np.array([[(i >> j) & 1 for j in range(3)]
                       for i in range(8)], np.uint8)
    rows = np.tile(combos, (9, 1))[:70]
    state = np.zeros((70, jp.init_mask.shape[1]), np.uint8)
    for i in range(3):
        state[:, prog.input_map[f"x{i}"]] = rows[:, i:i + 1]
    words = pack_rows(state, 32)
    twin, wrap, ref, pal = _k1_all(words, jp, 1)
    assert np.array_equal(twin, ref)
    assert np.array_equal(twin, pal)
    assert np.array_equal(twin, wrap)
    y = prog.output_map["y"][0]
    got = [(int(twin[r // 32, y]) >> (r % 32)) & 1 for r in range(70)]
    arity = GATE_ARITY[gate]
    want = [eval_gate(gate, tuple(int(x) for x in r[:max(arity, 1)]))
            for r in rows]
    assert got == want


def test_k1_plain_and_write_semantics():
    """No-init AND: a gate result AND-writes into what the output cell
    already holds (X-MAGIC input overwriting)."""
    lay = Layout()
    p = lay.new_partition()
    x = lay.add_cell(p, "x")
    y = lay.add_cell(p, "y")
    b = ProgramBuilder(lay)
    b.declare_input("x", [x])
    b.declare_input("y", [y])
    b.declare_output("y", [y])
    b.cycle([Op(Gate.NOT, (x,), y)])
    jp = pack_program(b.build(validate=False))
    rows = np.array([[0, 0], [0, 1], [1, 0], [1, 1]], np.uint8)
    state = np.zeros((4, jp.init_mask.shape[1]), np.uint8)
    state[:, [x, y]] = rows
    twin, wrap, ref, pal = _k1_all(pack_rows(state, 32), jp, 1)
    assert np.array_equal(twin, ref) and np.array_equal(twin, pal)
    assert np.array_equal(twin, wrap)
    got = [(int(twin[0, y]) >> r) & 1 for r in range(4)]
    assert got == [int(yv & (1 - xv)) for xv, yv in rows]


@pytest.mark.parametrize("rows", [3, 33, 70])
@pytest.mark.parametrize("kind,n", [("multpim", 4), ("multpim", 8),
                                    ("multpim_mac", 8), ("rime", 8)])
def test_k1_plain_ragged_rows(kind, n, rows):
    """Whole programs over random state at row counts straddling the
    32-bit word: every word, tail bits included, matches."""
    jp = compile_cached(kind, n).packed
    rng = np.random.default_rng(rows * n)
    state = rng.integers(0, 2, (rows, jp.init_mask.shape[1]), np.uint8)
    twin, wrap, ref, pal = _k1_all(pack_rows(state, 32), jp, 8)
    assert np.array_equal(twin, ref)
    assert np.array_equal(twin, pal)
    assert np.array_equal(twin, wrap)


@pytest.mark.parametrize("macro", [1, 3, 8, 1000])
def test_k1_plain_macro_factor(macro):
    """Any fusion depth, one longer than the program included, gives the
    same words as the references."""
    jp = compile_cached("multpim", 8).packed
    rng = np.random.default_rng(macro)
    state = rng.integers(0, 2, (50, jp.init_mask.shape[1]), np.uint8)
    twin, wrap, ref, pal = _k1_all(pack_rows(state, 32), jp, macro)
    assert np.array_equal(twin, ref) and np.array_equal(twin, pal)
    assert np.array_equal(twin, wrap)


# ----------------------------------------------------------------- K2 ----
@pytest.mark.parametrize("rows", [3, 33, 70])
@pytest.mark.parametrize("kind,n", [("multpim", 4), ("multpim", 8),
                                    ("multpim_mac", 4)])
def test_k2_plain_matches_jax(kind, n, rows):
    """The unpacked plain version equals the JAX scan reference and the
    unpacked Pallas kernel on random {0,1} state."""
    jp = compile_cached(kind, n).packed
    rng = np.random.default_rng(rows + n)
    state = rng.integers(0, 2, (rows, jp.init_mask.shape[1]), np.uint8)
    pp = _port(jp)
    twin = crossbar_run_ref(torch.from_numpy(state), pp).numpy()
    wrap = crossbar_run(torch.from_numpy(state), pp).numpy()
    ref = np.asarray(jax_run_ref(jnp.asarray(state), jp))
    pal = np.asarray(crossbar_run_pallas(jnp.asarray(state), jp,
                                         interpret=True))
    assert twin.dtype == np.uint8
    assert np.array_equal(twin, ref)
    assert np.array_equal(twin, pal)
    assert np.array_equal(twin, wrap)


# ------------------------------------------- a cycle ANDs its writes ----
def _jax_table(arrays) -> PackedProgram:
    """The JAX package's packed program of a shared dense table."""
    c = arrays[3].shape[1]
    return PackedProgram(*arrays, n_cols=c - 1, scratch_col=c - 1)


@pytest.mark.parametrize("table", ["dup", "random0", "random1"])
def test_cycle_ands_every_write(table):
    """Where two ops of one cycle write one column, both plain versions
    leave the AND of their results, as the JAX package's scan reference
    and its packed Pallas kernel (interpret mode) do: on the
    duplicate-write table, rows (a, b) = (0,1), (1,0), (0,0), (1,1) with
    column 2 at 1 give [0, 0, 1, 0]."""
    if table == "dup":
        jp = _jax_table(dup_write_table())
        state = np.zeros((4, 4), np.uint8)
        state[:, 0], state[:, 1], state[:, 2] = [0, 1, 0, 1], [1, 0, 0, 1], 1
    else:
        jp = _jax_table(random_dup_table(int(table[-1])))
        rng = np.random.default_rng(int(table[-1]) + 10)
        state = rng.integers(0, 2, (45, jp.init_mask.shape[1]), np.uint8)
    pp = _port(jp)
    assert kernel_tables(pp, "cpu").held
    twin = crossbar_run_ref(torch.from_numpy(state), pp).numpy()
    assert np.array_equal(twin, np.asarray(jax_run_ref(jnp.asarray(state),
                                                       jp)))
    assert np.array_equal(twin, crossbar_run(torch.from_numpy(state),
                                             pp).numpy())
    words = pack_rows(state, 32)
    pal = np.asarray(crossbar_run_pallas_packed(jnp.asarray(words), jp,
                                                macro=1, interpret=True))
    for macro in (1, 3):
        got = words_to_numpy(crossbar_run_ref_packed(words_to_torch(words),
                                                     pp, macro=macro))
        assert np.array_equal(got, pal)
    assert np.array_equal(unpack_rows(pal, state.shape[0]), twin)
    if table == "dup":
        assert twin[:, 2].tolist() == [0, 0, 1, 0]


@pytest.mark.parametrize("n", [4, 8])
@pytest.mark.parametrize("kind", ["multpim", "multpim_mac", "stage",
                                  "recomb"])
def test_compiled_families_unchanged_by_and_writes(kind, n):
    """Compiled programs write distinct columns in every cycle: the
    packed scan keeps its one index write per cycle (no cycle is
    serial), and both plain versions equal the JAX package's scan
    references bit for bit."""
    from repro_torch.kernels.ref import packed_device_tables
    jp = compile_cached(kind, n).packed
    pp = _port(jp)
    assert packed_device_tables(pp, 1, "cpu").serial == {}
    assert packed_device_tables(pp, 8, "cpu").serial == {}
    rng = np.random.default_rng(n)
    state = rng.integers(0, 2, (45, jp.init_mask.shape[1]), np.uint8)
    twin = crossbar_run_ref(torch.from_numpy(state), pp).numpy()
    assert np.array_equal(twin, np.asarray(jax_run_ref(jnp.asarray(state),
                                                       jp)))
    words = pack_rows(state, 32)
    got = words_to_numpy(crossbar_run_ref_packed(words_to_torch(words), pp,
                                                 macro=8))
    assert np.array_equal(got, np.asarray(jax_run_ref_packed(
        jnp.asarray(words), jp, macro=1)))


# --------------------------------------------------- wrapper contract ----
def test_wrappers_use_plain_version_on_cpu_without_counting():
    """A CPU tensor runs the plain version; the launch counters count
    kernel launches only."""
    pp = _port(compile_cached("multpim", 4).packed)
    c = pp.init_mask.shape[1]
    k1, k2 = crossbar_run_packed.launches, crossbar_run.launches
    crossbar_run_packed(torch.zeros((2, c), dtype=torch.int32), pp)
    crossbar_run(torch.zeros((5, c), dtype=torch.uint8), pp)
    assert (crossbar_run_packed.launches, crossbar_run.launches) == (k1, k2)


@pytest.mark.parametrize("bad", ["dtype", "width", "ndim"])
def test_wrappers_reject_bad_state(bad):
    pp = _port(compile_cached("multpim", 4).packed)
    c = pp.init_mask.shape[1]
    shape = {"dtype": (2, c), "width": (2, c - 1), "ndim": (2, c, 1)}[bad]
    k1_dt, k2_dt = ((torch.uint8, torch.int32) if bad == "dtype"
                    else (torch.int32, torch.uint8))
    with pytest.raises(ValueError):
        crossbar_run_packed(torch.zeros(shape, dtype=k1_dt), pp)
    with pytest.raises(ValueError):
        crossbar_run(torch.zeros(shape, dtype=k2_dt), pp)


def test_kernel_tables_layout_and_memo():
    """The kernels' tables reproduce the packed program: the record
    stream holds its real slots in order with per-cycle offsets, the
    init CSR its init cells, and the uploaded command stream is
    :func:`command_stream`'s; they are uploaded once per device."""
    jp = compile_cached("multpim", 4).packed
    pp = _port(jp)
    tabs = kernel_tables(pp, "cpu")
    assert kernel_tables(pp, "cpu") is tabs
    s = pp.n_cycles
    assert s == jp.gate_id.shape[0]
    assert tabs.n_cols == jp.init_mask.shape[1]
    real = jp.gate_id != 0
    records, op_ptr, max_ops, held = encode_records(pp)
    assert tabs.n_records == records.size == int(real.sum())
    assert (tabs.max_ops, tabs.held) == (max_ops, held)
    assert np.array_equal(np.diff(op_ptr), real.sum(axis=1))
    assert tabs.stream.dtype == torch.int64
    stream, n_steps, max_step = command_stream(
        records, op_ptr, tabs.init_ptr, tabs.init_cols,
        tabs.n_cols)
    assert np.array_equal(tabs.stream.numpy(), stream)
    assert (tabs.n_steps, tabs.max_step) == (n_steps, max_step)
    gate, ins, out, _ = decode_records(records)
    assert np.array_equal(gate, jp.gate_id[real])
    assert np.array_equal(out, jp.out_col[real])
    assert np.array_equal(ins[:, 0], jp.in_cols[real][:, 0])
    ptr, cols = tabs.init_ptr, tabs.init_cols
    for i in range(s):
        assert sorted(cols[ptr[i]:ptr[i + 1]]) == list(
            np.nonzero(jp.init_mask[i])[0])


def test_convert_roundtrip():
    rng = np.random.default_rng(0)
    w = rng.integers(0, 2 ** 32, (7, 5), dtype=np.uint64).astype(np.uint32)
    t = words_to_torch(w)
    assert t.dtype == torch.int32
    assert np.array_equal(words_to_numpy(t), w)
    jp = compile_cached("stage", 4).packed
    pp = _port(jp)
    assert (pp.n_cols, pp.scratch_col) == (jp.n_cols, jp.scratch_col)
    with pytest.raises(ValueError):
        packed_from_arrays(jp.gate_id, jp.in_cols[:-1], jp.out_col,
                           jp.init_mask)
