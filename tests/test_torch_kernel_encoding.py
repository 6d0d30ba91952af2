"""The host-side pieces of repro_torch's redesigned kernels, on the CPU.

K3 (bit-serial matmul): the bf16 split of float32 w (``split_bf16x3``)
and the 8-bit pieces of x (``_x_pieces``) are exact, and a plain
emulation of the kernel's decomposition (``_split_matmul``:
sum_p sum_q X_p @ W_q) equals the port's plain version and the JAX
package's Pallas kernel (interpret mode) bit for bit on integer cases.
K1 (packed crossbar step): the compact op stream (``encode_records``)
decodes back to the packed program's real slots in order, with the same
init CSR, for every program family and a co-scheduled table, and a plain
run of the records' gate form, and of the command stream the kernel
reads (``command_stream``), equals both packages' packed references.
K2 (unpacked crossbar step) is K1's engine between a pack of 32 rows of
bytes into each word and an unpack: the unpacked plain version equals
the packed one between ``pack_rows`` and ``unpack_rows``, and a numpy
emulation of the kernel's pack (lane per row, funnel-shifted 32-bit
reads, ballots) and unpack gives ``pack_rows``' words and the bytes
back. The kernels themselves are held against the plain versions on a card in
``tests/test_torch_cuda.py`` and ``chip_smoke.py``."""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.compiler.cache import compile_cached as jax_compile  # noqa: E402
from repro.kernels.ops import bitserial_matmul as jax_bitserial  # noqa: E402
from repro.kernels.ref import (  # noqa: E402
    bitserial_matmul_ref as jax_bitserial_ref,
    crossbar_run_ref_packed as jax_run_ref_packed)
from repro_torch.compiler.cache import compile_cached  # noqa: E402
from repro_torch.convert import (packed_from_arrays,  # noqa: E402
                                 words_to_numpy, words_to_torch)
from repro_torch.core.bits import pack_rows, unpack_rows  # noqa: E402
from repro_torch.core.isa import GATE_ARITY, Gate  # noqa: E402
from repro_torch.engine import Engine  # noqa: E402
from repro_torch.kernels.bitserial_matmul import split_bf16x3  # noqa: E402
from repro_torch.kernels.crossbar_step import (  # noqa: E402
    MAX_RECORD_COLS, command_stream, decode_records, encode_records,
    kernel_tables)
from repro_torch.kernels.ref import (  # noqa: E402
    bitserial_matmul_ref, crossbar_run_ref, crossbar_run_ref_packed)
from _tables import held_table  # noqa: E402

pytestmark = pytest.mark.kernels

FAMILIES = ["hajali", "multpim", "multpim_mac", "recomb", "rime", "stage"]


def _is_bf16(t: torch.Tensor) -> bool:
    return torch.equal(t, t.to(torch.bfloat16).to(torch.float32))


def _x_pieces(x: torch.Tensor, n_bits: int) -> "list[torch.Tensor]":
    """K3's ``ceil(n_bits / 8)`` pieces of ``x & (2^n - 1)`` as float32:
    ``((x >> 8p) & 255) * 2^(8p)``, each exact in bf16."""
    v = x & ((1 << n_bits) - 1)
    return [(((v >> (8 * p)) & 255) << (8 * p)).to(torch.float32)
            for p in range(-(-n_bits // 8))]


def _split_matmul(x: torch.Tensor, w: torch.Tensor,
                  n_bits: int = 8) -> torch.Tensor:
    """K3's decomposition in plain PyTorch: ``sum_p sum_q X_p @ W_q`` in
    float32 over the pieces of :func:`_x_pieces` and ``split_bf16x3``.
    Every piece is a bf16 value held in float32, so each product term is
    exact; only the order of the sums differs from the kernel's."""
    acc = torch.zeros((x.shape[0], w.shape[1]), dtype=torch.float32)
    ws = split_bf16x3(w)
    for xp in _x_pieces(x, n_bits):
        for wq in ws:
            acc += xp @ wq
    return acc


# ------------------------------------------------------------ K3 split ----
@pytest.mark.parametrize("scale", [1e-3, 1.0, 1e3, 1e10, 1e30])
def test_split_bf16x3_is_exact(scale):
    """w0 + w1 + w2 == w exactly (summed in float64), each piece a bf16,
    on normals of both signs at magnitudes 1e-3 to 1e30."""
    rng = np.random.default_rng(int(np.log10(scale)) + 10)
    w = torch.from_numpy((rng.standard_normal(100_000) * scale)
                         .astype(np.float32))
    pieces = split_bf16x3(w)
    assert all(_is_bf16(p) for p in pieces)
    total = sum(p.double() for p in pieces)
    assert torch.equal(total, w.double())


def test_split_bf16x3_integer_weights_one_piece():
    """The quantizer's integer weights 0..255 (and their negatives) are
    their first piece alone: the kernel skips the other two products."""
    w = torch.arange(-255, 256, dtype=torch.float32)
    w0, w1, w2 = split_bf16x3(w)
    assert torch.equal(w0, w)
    assert not w1.any() and not w2.any()


@pytest.mark.parametrize("n_bits", [1, 7, 8, 9, 12, 16, 17, 23])
def test_x_pieces_are_exact(n_bits):
    """The ceil(n/8) pieces of x & (2^n - 1) are bf16 values that sum to
    it exactly."""
    rng = np.random.default_rng(n_bits)
    x = torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31, 5000)
                         .astype(np.int32))
    pieces = _x_pieces(x, n_bits)
    assert len(pieces) == -(-n_bits // 8)
    assert all(_is_bf16(p) for p in pieces)
    total = sum(p.double() for p in pieces)
    assert torch.equal(total, (x.long() & ((1 << n_bits) - 1)).double())


@pytest.mark.parametrize("m,k,n,bits,w_lo,w_hi", [
    (70, 60, 130, 12, -64, 64),      # two x pieces
    (8, 256, 64, 8, 0, 256),         # the quantizer's weights, exact range
    (33, 40, 47, 17, -3, 4),         # three x pieces
    (5, 1000, 9, 4, -64, 64)])
def test_k3_decomposition_bit_exact_on_integers(m, k, n, bits, w_lo, w_hi):
    """sum_p sum_q X_p @ W_q in float32 equals the port's plain version,
    the JAX package's Pallas kernel (interpret mode) and its plain
    reference bit for bit when every sum is an integer under 2^24."""
    rng = np.random.default_rng(m + k + n + bits)
    x = rng.integers(0, 1 << bits, (m, k)).astype(np.int32)
    w = rng.integers(w_lo, w_hi, (k, n)).astype(np.float32)
    assert (np.abs(x).astype(np.int64) @ np.abs(w).astype(np.int64)
            ).max() < 2 ** 24
    got = _split_matmul(torch.from_numpy(x), torch.from_numpy(w),
                        bits).numpy()
    plain = bitserial_matmul_ref(torch.from_numpy(x), torch.from_numpy(w),
                                 bits).numpy()
    exact = (x.astype(np.int64) @ w.astype(np.int64)).astype(np.float32)
    pallas = np.asarray(jax_bitserial(jnp.asarray(x), jnp.asarray(w), bits))
    ref = np.asarray(jax_bitserial_ref(jnp.asarray(x), jnp.asarray(w), bits))
    assert np.array_equal(got, exact)
    assert np.array_equal(got, plain)
    assert np.array_equal(got, pallas)
    assert np.array_equal(got, ref)


@pytest.mark.parametrize("m,k,n", [(17, 130, 33), (64, 1000, 70)])
def test_k3_decomposition_float_w(m, k, n):
    """With float w the decomposition sums exact terms in another order:
    within the reference's rtol 1e-4 / atol 5e-3 of the port's plain
    version and of the JAX package's Pallas kernel, at 8 bits."""
    rng = np.random.default_rng(m * k)
    x = rng.integers(0, 256, (m, k)).astype(np.int32)
    w = rng.standard_normal((k, n)).astype(np.float32)
    got = _split_matmul(torch.from_numpy(x), torch.from_numpy(w))
    plain = bitserial_matmul_ref(torch.from_numpy(x), torch.from_numpy(w))
    pallas = np.array(jax_bitserial(jnp.asarray(x), jnp.asarray(w), 8))
    torch.testing.assert_close(got, plain, rtol=1e-4, atol=5e-3)
    torch.testing.assert_close(got, torch.from_numpy(pallas), rtol=1e-4,
                               atol=5e-3)


# ---------------------------------------------------------- K1 records ----
def _run_records(words: torch.Tensor, packed) -> torch.Tensor:
    """The records' own semantics in plain PyTorch: per cycle, SET the
    init cells, gather maj(s[a], s[b], s[c]) ^ inv over the state with
    the kernel's two constant columns (C all zeros, C + 1 all ones),
    then AND-write each result in turn."""
    tabs = kernel_tables(packed, "cpu")
    w = words.shape[0]
    s = torch.cat([words, torch.zeros((w, 1), dtype=torch.int32),
                   torch.full((w, 1), -1, dtype=torch.int32)], dim=1)
    records, ptr, _, _ = encode_records(packed)
    _, ins, out, inv = decode_records(records)
    ip = tabs.init_ptr
    ic = tabs.init_cols
    for t in range(packed.n_cycles):
        s[:, torch.from_numpy(ic[ip[t]:ip[t + 1]]).long()] = -1
        sl = slice(ptr[t], ptr[t + 1])
        a, b, c = (s[:, torch.from_numpy(ins[sl, j]).long()]
                   for j in range(3))
        res = ((a & b) | (a & c) | (b & c)) ^ torch.from_numpy(
            -inv[sl].astype(np.int32))
        for j, o in enumerate(out[sl]):
            s[:, o] &= res[:, j]
    return s[:, :words.shape[1]]


def _run_command_stream(words: torch.Tensor, packed) -> torch.Tensor:
    """The kernel's command stream in plain PyTorch: per step, a header
    (the count of SET entries in its low 32 bits, of ops in its high 32),
    SET entries of four columns each, then op records, on the state with
    the two constant columns."""
    tabs = kernel_tables(packed, "cpu")
    cmd = tabs.stream.numpy().view(np.uint64)
    w, c = words.shape
    s = torch.cat([words, torch.zeros((w, 1), dtype=torch.int32),
                   torch.full((w, 1), -1, dtype=torch.int32)], dim=1)
    fields = [(0, 0xFFF), (20, 0xFFF), (32, 0xFFF), (52, 0xFFF)]
    pos = 0
    for _ in range(tabs.n_steps):
        head = int(cmd[pos])
        n_set, n_op = head & 0xFFFFFFFF, head >> 32
        for e in cmd[pos + 1:pos + 1 + n_set]:
            s[:, [(int(e) >> f) & m for f, m in fields]] = -1
        ops = cmd[pos + 1 + n_set:pos + 1 + n_set + n_op].view(np.int64)
        _, ins, out, inv = decode_records(ops)
        a, b, cc = (s[:, torch.from_numpy(ins[:, j]).long()]
                    for j in range(3))
        res = ((a & b) | (a & cc) | (b & cc)) ^ torch.from_numpy(
            -inv.astype(np.int32))
        for j, o in enumerate(out):
            s[:, o] &= res[:, j]
        pos += 1 + n_set + n_op
    assert pos == tabs.stream.numel() or tabs.n_steps == 0
    return s[:, :c]


def _check_stream(packed) -> None:
    tabs = kernel_tables(packed, "cpu")
    gate_t, ins_t, out_t = (np.asarray(packed.gate_id),
                            np.asarray(packed.in_cols),
                            np.asarray(packed.out_col))
    tt, mm = np.nonzero(gate_t != 0)
    records, op_ptr, max_ops, held = encode_records(packed)
    gate, ins, out, inv = decode_records(records)
    c = packed.init_mask.shape[1]
    assert tabs.n_records == tt.size
    assert np.array_equal(gate, gate_t[tt, mm])
    assert np.array_equal(out, out_t[tt, mm])
    for g in np.unique(gate):
        sel = gate == g
        ar = GATE_ARITY[Gate(int(g))]
        # the gate's own operands, then the record form's fillers
        assert np.array_equal(ins[sel, :ar], ins_t[tt, mm][sel, :ar])
        assert set(inv[sel]) == {int(Gate(int(g)) in (
            Gate.NOT, Gate.NOR, Gate.MIN3, Gate.NAND))}
        if Gate(int(g)) in (Gate.NOT, Gate.COPY):
            assert np.array_equal(ins[sel, 1], ins[sel, 0])
            assert np.array_equal(ins[sel, 2], ins[sel, 0])
        elif ar == 2:
            const = c + 1 if Gate(int(g)) in (Gate.NOR, Gate.OR) else c
            assert (ins[sel, 2] == const).all()
    counts = (gate_t != 0).sum(axis=1)
    assert np.array_equal(np.diff(op_ptr), counts)
    assert max_ops == tabs.max_ops == counts.max(initial=0)
    ptr, cols = tabs.init_ptr, tabs.init_cols
    for t in range(gate_t.shape[0]):
        assert sorted(cols[ptr[t]:ptr[t + 1]]) == list(
            np.nonzero(packed.init_mask[t])[0])
    assert not held and not tabs.held


@pytest.mark.parametrize("n", [4, 8, 16, 32])
@pytest.mark.parametrize("kind", FAMILIES)
def test_records_decode_to_real_slots(kind, n):
    """Every family's record stream is its real (non-NOP) slots in cycle
    and slot order, with the gate form's fillers, per-cycle offsets of
    the real-op counts and the same init CSR; no cycle needs the held
    path."""
    _check_stream(compile_cached(kind, n).packed)


def test_records_of_coscheduled_table():
    """The fused table of two co-scheduled N = 32 MACs: C = 855, 64 ops
    a cycle, 12,352 records."""
    packed = Engine("torch:device=cpu").compile_batch("mac", 32, 2).packed
    assert packed.init_mask.shape[1] == 855
    assert packed.gate_id.shape[1] == 64
    _check_stream(packed)
    assert kernel_tables(packed, "cpu").n_records == 12352


@pytest.mark.parametrize("kind,n", [("multpim", 8), ("rime", 4),
                                    ("stage", 8), ("hajali", 4)])
def test_record_semantics_match_packed_references(kind, n):
    """Run as the kernel reads them, the records give the port's and the
    JAX package's packed references' final words bit for bit."""
    jp = jax_compile(kind, n).packed
    pp = packed_from_arrays(jp.gate_id, jp.in_cols, jp.out_col,
                            jp.init_mask)
    rng = np.random.default_rng(n)
    words = rng.integers(0, 2 ** 32, (7, jp.init_mask.shape[1]),
                         dtype=np.uint64).astype(np.uint32)
    got = _run_records(words_to_torch(words), pp)
    assert torch.equal(got, crossbar_run_ref_packed(words_to_torch(words),
                                                    pp))
    ref = np.asarray(jax_run_ref_packed(jnp.asarray(words), jp, macro=1))
    assert np.array_equal(words_to_numpy(got), ref)
    assert torch.equal(_run_command_stream(words_to_torch(words), pp), got)


def test_record_semantics_on_coscheduled_table():
    packed = Engine("torch:device=cpu").compile_batch("mac", 8, 4).packed
    words = words_to_torch(np.random.default_rng(1).integers(
        0, 2 ** 32, (5, packed.init_mask.shape[1]),
        dtype=np.uint64).astype(np.uint32))
    want = crossbar_run_ref_packed(words, packed)
    assert torch.equal(_run_records(words, packed), want)
    assert torch.equal(_run_command_stream(words, packed), want)


def test_command_stream_steps():
    """NOP-only cycles make no step; a step of 1,100 SETs (275 entries)
    and one of 300 ops each fit the ring, and the stream runs to the
    packed reference's words."""
    rng = np.random.default_rng(7)
    t, m, c = 3, 300, 1200
    gate = np.zeros((t, m), np.int32)
    gate[1] = int(Gate.NOT)
    ins = np.zeros((t, m, 3), np.int32)
    ins[1, :, 0] = rng.integers(0, 600, m)
    out = np.full((t, m), c - 1, np.int32)
    out[1] = 600 + np.arange(m)
    init = np.zeros((t, c), bool)
    init[0, :1100] = True
    packed = packed_from_arrays(gate, ins, out, init)
    tabs = kernel_tables(packed, "cpu")
    assert not tabs.held
    assert (tabs.n_steps, tabs.max_step) == (2, 1 + 300)
    assert tabs.stream.numel() == 1 + 275 + 1 + 300
    words = words_to_torch(rng.integers(0, 2 ** 32, (4, c),
                                        dtype=np.uint64).astype(np.uint32))
    assert torch.equal(_run_command_stream(words, packed),
                       crossbar_run_ref_packed(words, packed))


@pytest.mark.parametrize("cols", [MAX_RECORD_COLS + 1, 4096, 5000])
def test_record_field_limit_raises(cols):
    """12-bit column fields and two constant columns: C + 2 > 4096
    raises instead of clipping; C = 4094 encodes."""
    def table(c):
        gate = np.array([[int(Gate.NOR)]], np.int32)
        ins = np.array([[[c - 2, 0, 0]]], np.int32)
        return packed_from_arrays(gate, ins, np.array([[c - 3]], np.int32),
                                  np.zeros((1, c), bool))
    with pytest.raises(ValueError, match="12-bit"):
        encode_records(table(cols))
    rec, _, _, _ = encode_records(table(MAX_RECORD_COLS))
    _, ins, out, _ = decode_records(rec)
    assert (ins[0, 0], ins[0, 2], out[0]) == (MAX_RECORD_COLS - 2,
                                              MAX_RECORD_COLS + 1,
                                              MAX_RECORD_COLS - 3)


def test_held_when_a_cycle_reads_or_rewrites_its_outputs():
    """A cycle whose op reads another op's output column, or whose two
    ops write one column, makes the table held; reads of columns
    written in earlier cycles do not."""
    gate = np.array([[int(Gate.NOT), int(Gate.NOT)]], np.int32)
    ins = np.zeros((1, 2, 3), np.int32)
    init = np.zeros((1, 6), bool)

    def held(in0, outs):
        ins[0, :, 0] = in0
        return encode_records(packed_from_arrays(
            gate, ins, np.array([outs], np.int32), init))[3]

    assert not held([0, 1], [2, 3])
    assert held([0, 2], [2, 3])          # op 1 reads op 0's output
    assert held([0, 1], [2, 2])          # both write column 2
    two = packed_from_arrays(np.array([[1], [1]], np.int32),
                             np.array([[[0, 0, 0]], [[2, 0, 0]]], np.int32),
                             np.array([[2], [3]], np.int32),
                             np.zeros((2, 6), bool))
    assert not encode_records(two)[3]


# ------------------------------------------------- K2: pack and unpack ----
def _check_identity(packed, rows: int, seed: int) -> None:
    """The unpacked plain version equals the packed one between
    ``pack_rows`` and ``unpack_rows``: the function K2 computes."""
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2, (rows, packed.init_mask.shape[1]), np.uint8)
    want = crossbar_run_ref(torch.from_numpy(bits), packed).numpy()
    words = crossbar_run_ref_packed(words_to_torch(pack_rows(bits, 32)),
                                    packed)
    assert np.array_equal(unpack_rows(words_to_numpy(words), rows), want)


@pytest.mark.parametrize("n", [4, 8])
@pytest.mark.parametrize("kind", FAMILIES)
def test_unpacked_run_is_packed_run_between_pack_and_unpack(kind, n):
    """Every family at rows 1, 31, 33 and 70 (ragged last words)."""
    packed = compile_cached(kind, n).packed
    for rows in (1, 31, 33, 70):
        _check_identity(packed, rows, rows + n)


@pytest.mark.parametrize("dup", [False, True])
def test_unpacked_run_is_packed_run_on_held_tables(dup):
    packed = packed_from_arrays(*held_table(dup))
    assert kernel_tables(packed, "cpu").held
    for rows in (1, 33, 70):
        _check_identity(packed, rows, rows)


def test_unpacked_run_is_packed_run_on_coscheduled_table():
    packed = Engine("torch:device=cpu").compile_batch("mac", 32, 2).packed
    assert packed.init_mask.shape[1] == 855
    _check_identity(packed, 70, 5)


def _k2_pack(bits: np.ndarray, rng) -> np.ndarray:
    """K2's tile load (``pack_word``) in numpy: per word, its rows'
    bytes in a staging buffer of 32 C + 48 bytes (the rest stale),
    read as little-endian 32-bit words; lane l takes row l from byte
    l C, four columns per funnel shift of two words, and ballot j of
    read k over the column group from c0 gives column c0 + 4k + j, one
    bit per lane (rows past the word's read as 0). Returns the
    ``(words, C)`` uint32 column words."""
    rows, c = bits.shape
    n_words = -(-rows // 32)
    flat = bits.reshape(-1)
    tile = np.zeros((n_words, c), np.uint64)
    lanes = np.arange(32)
    row0 = lanes * c
    sh = (8 * (row0 & 3)).astype(np.uint64)
    for w in range(n_words):
        here = min(32, rows - 32 * w)
        buf = rng.integers(0, 256, 32 * c + 48, dtype=np.uint8)
        buf[:here * c] = flat[32 * w * c:(32 * w + here) * c]
        p = buf.view("<u4").astype(np.uint64)
        ok = lanes < here
        for c0 in range(0, c, 32):
            q = (row0 + c0) >> 2
            lo = np.where(ok, p[q], 0)
            for k in range(8):
                hi = np.where(ok, p[q + k + 1], 0)
                v = (((hi << np.uint64(32)) | lo) >> sh) & np.uint64(
                    0xFFFFFFFF)
                lo = hi
                for j in range(4):
                    col = c0 + 4 * k + j
                    ballot = int(((v >> np.uint64(8 * j)) & np.uint64(1))
                                 @ (np.uint64(1) << lanes.astype(np.uint64)))
                    if col < c:
                        tile[w, col] = ballot
    return tile.astype(np.uint32)


def _k2_unpack(tile: np.ndarray, rows: int, rng) -> np.ndarray:
    """K2's tile store (``unpack_word``) in numpy: lane l writes row l of
    each word from bit l of four column words at a time, as one 32-bit
    store where C is a multiple of 4, else byte by byte, into a buffer of
    stale bytes; rows past the word's are never written."""
    n_words, c = tile.shape
    out = []
    for w in range(n_words):
        here = min(32, rows - 32 * w)
        buf = rng.integers(0, 256, 32 * c + 48, dtype=np.uint8)
        stale = buf.copy()
        for lane in range(here):
            for c0 in range(0, c, 4):
                v = 0
                for j in range(4):
                    if c0 + j < c:
                        v |= ((int(tile[w, c0 + j]) >> lane) & 1) << (8 * j)
                at = lane * c + c0
                if c % 4 == 0:
                    assert at % 4 == 0
                    buf[at:at + 4] = np.array([v], "<u4").view(np.uint8)
                else:
                    for j in range(min(4, c - c0)):
                        buf[at + j] = (v >> (8 * j)) & 255
        assert np.array_equal(buf[here * c:], stale[here * c:])
        out.append(buf[:here * c].reshape(here, c))
    return np.concatenate(out)


@pytest.mark.parametrize("rows", [1, 31, 33, 70])
@pytest.mark.parametrize("cols", [1, 3, 6, 32, 290, 322, 460, 855])
def test_k2_pack_and_unpack_emulation(cols, rows):
    """The kernel's transpose order (lane = row, bit = lane, word = 32
    rows) gives ``core/bits.pack_rows``' words at any C, C not a
    multiple of 4 included, and its unpack gives the bytes back."""
    rng = np.random.default_rng(cols * 100 + rows)
    bits = rng.integers(0, 2, (rows, cols), np.uint8)
    tile = _k2_pack(bits, rng)
    assert np.array_equal(tile, pack_rows(bits, 32))
    assert np.array_equal(_k2_unpack(tile, rows, rng), bits)
