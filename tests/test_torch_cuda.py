"""repro_torch on a CUDA card: K1, K2 and K3 against their plain
PyTorch versions, the engine's packed/unpacked front door and resident
chain against exact integer results, the PIM linear layers against
float64 oracles, and serving (resident through K1, fault-checked,
unpacked through K2) against the plain-int reference tokens, the
``multpim_area`` tables, recorded command traces replayed through K1 and
K2, a disk-loaded cache entry run through K1, the PIM linear's phase
spans with their device times, the model zoo (two smoke
models and a full-width gemma2-9b block) against the CPU, and training
(two smoke models' train steps against the CPU, a checkpoint restored
onto the card, the launcher's default device), and the dry-run's
prediction of a decode cell's peak against a real step. Every test skips
without a card; on one,
run ``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py``
(this file imports no JAX, so it runs where JAX is not installed)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.compiler.cache import compile_cached  # noqa: E402
from repro_torch.engine import Engine  # noqa: E402
from repro_torch.convert import packed_from_arrays  # noqa: E402
from repro_torch.kernels.bitserial_matmul import bitserial_matmul  # noqa: E402
from repro_torch.kernels.crossbar_step import (  # noqa: E402
    crossbar_run, crossbar_run_packed, kernel_tables)
from repro_torch.kernels.ref import (  # noqa: E402
    bitserial_matmul_ref, crossbar_run_ref, crossbar_run_ref_packed)
from _tables import dup_write_table, held_table  # noqa: E402

pytestmark = pytest.mark.cuda

FAMILIES = ["hajali", "multpim", "multpim_area", "multpim_mac", "recomb",
            "residue", "rime", "stage"]


@pytest.fixture()
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.parametrize("kind,n", [("multpim", 8), ("multpim_mac", 8),
                                    ("rime", 8), ("stage", 8),
                                    ("recomb", 8), ("residue", 8),
                                    ("residue", 16)])
def test_kernels_match_plain_versions(card, kind, n):
    """K1 at several word counts and fusion depths, and K2 on a ragged
    row count, bit-identical to their plain versions."""
    packed = compile_cached(kind, n).packed
    c = packed.init_mask.shape[1]
    rng = np.random.default_rng(n)
    for words in (1, 33, 300):
        st = torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31, (words, c),
                                           dtype=np.int64).astype(np.int32))
        for macro in (1, 8):
            got = crossbar_run_packed(st.to(card), packed, macro=macro)
            assert torch.equal(got.cpu(),
                               crossbar_run_ref_packed(st, packed, macro))
    bits = torch.from_numpy(rng.integers(0, 2, (333, c), dtype=np.uint8))
    assert torch.equal(crossbar_run(bits.to(card), packed).cpu(),
                       crossbar_run_ref(bits, packed))


def test_engine_on_card(card):
    """Front door (packed and unpacked) and the resident matvec on the
    card equal the exact results; the chain launches K1 1 + 2(E-1) + 1
    times."""
    rng = np.random.default_rng(0)
    a = rng.integers(0, 1 << 16, 100)
    b = rng.integers(0, 1 << 16, 100)
    for spec in ("torch:pack=true", "torch:pack=false"):
        out = Engine(spec).compile("multpim", 16).run({"a": a, "b": b})
        assert [int(v) for v in out["out"]] == [int(x) * int(y)
                                                for x, y in zip(a, b)]
    A = rng.integers(0, 1 << 12, (70, 5))
    x = rng.integers(0, 1 << 12, 5)
    eng = Engine("torch:pack=true")
    before = crossbar_run_packed.launches
    res, _ = eng.matvec(A, x, 16, k=1, resident=True)
    assert crossbar_run_packed.launches - before == 1 + 2 * 4 + 1
    assert [int(v) for v in res] == [int(v) for v in A @ x]


@pytest.mark.parametrize("n", [8, 16, 32])
def test_coscheduled_on_card(card, n):
    """matvec with the default k on the card: k = min(coschedule_k, E)
    MACs fused into one K1 launch per pass (n = 16 and 32 take K1's
    halved row block: their fused tables exceed 800 columns); products
    equal numpy's and cycles the host interpreter's, below the k=1
    chain's. One compile_group pass equals the host interpreter."""
    rng = np.random.default_rng(n)
    eng, host = Engine("torch:pack=true"), Engine("numpy")
    k = eng.effective_coschedule_k("mac", n)
    assert k >= 2
    A = rng.integers(0, 1 << (n - 2), (300, 9))
    x = rng.integers(0, 1 << (n - 2), 9)
    before = crossbar_run_packed.launches
    res, cycles = eng.matvec(A, x, n)
    assert crossbar_run_packed.launches - before == -(-9 // k)
    mask = (1 << (2 * n)) - 1
    assert [int(v) for v in res] == [
        int(v) & mask for v in A.astype(object) @ x.astype(object)]
    _, host_cycles = host.matvec(A, x, n)
    _, chain_cycles = host.matvec(A, x, n, k=1)
    assert cycles == host_cycles < chain_cycles
    group = [("mac", 8, 2), ("multpim", n // 2), ("rime", 4)]
    macs = [{name: rng.integers(0, 2, (70, 8), dtype=np.uint8)
             for name in ("a", "b", "un", "s_lo", "c_lo", "c_lo_n")}
            for _ in range(2)]
    muls = [{"a": rng.integers(0, 1 << w, 70),
             "b": rng.integers(0, 1 << w, 70)} for w in (n // 2, 4)]
    before = crossbar_run_packed.launches
    got = eng.compile_group(group).run(macs + muls)
    assert crossbar_run_packed.launches - before == 1
    want = host.compile_group(group).run(macs + muls)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for name in w:
            assert [int(v) for v in np.ravel(g[name])] == \
                [int(v) for v in np.ravel(w[name])]
    assert [int(v) for v in got[2]["out"]] == [
        int(p) * int(q) for p, q in zip(muls[0]["a"], muls[0]["b"])]


@pytest.mark.parametrize("m,k,n,bits", [
    (1, 1, 1, 8), (17, 130, 33, 4), (100, 96, 60, 8), (64, 64, 64, 2),
    (129, 1000, 70, 8)])
def test_k3_matches_plain_version(card, m, k, n, bits):
    """K3 on ragged shapes: bit-exact with integer w in the exact range
    (every order of the sums is exact), within rtol 1e-4 / atol 5e-3 of
    the plain version with float w (the reference's tolerance; the two
    sum in different orders), one launch per call."""
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(m * k + n)
    x = torch.from_numpy(rng.integers(0, 1 << bits, (m, k)).astype(np.int32))
    wi = torch.from_numpy(rng.integers(-64, 64, (k, n)).astype(np.float32))
    wf = torch.from_numpy(rng.standard_normal((k, n)).astype(np.float32))
    before = bitserial_matmul.launches
    got = bitserial_matmul(x.to(card), wi.to(card), bits)
    assert bitserial_matmul.launches == before + 1
    exact = (x.long() @ wi.long()).float()
    assert torch.equal(got.cpu(), exact)
    got = bitserial_matmul(x.to(card), wf.to(card), bits).cpu()
    want = bitserial_matmul_ref(x, wf, bits)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=5e-3)


@pytest.mark.parametrize("m,k,n,bits", [
    (64, 32, 64, 8),            # exactly one 64 x 64 tile, one K tile
    (65, 33, 130, 8),           # ragged M, K and N on 64 x 64 tiles
    (256, 64, 8200, 8),         # 128 x 64 tiles (128 x 128 gives 130)
    (200, 72, 16500, 8),        # 128 x 128 tiles, ragged M, N and K
    (70, 60, 130, 12),          # two 8-bit pieces of x
    (33, 40, 47, 17)])          # three pieces, odd N: 4-byte copies
def test_k3_tiles_and_pieces(card, m, k, n, bits):
    """K3 on shapes that straddle its tiles and its x pieces: bit-exact
    with integer w in [-h, h), h = 64 or less, so that every sum stays
    under 2^24 and every order is exact. With float w, within rtol 1e-4
    / atol 5e-3 of the plain version, the rtol taken against the scale of
    the summed terms, |x| @ |w| (as chip_smoke.py does): at 12 and 17
    bits the sums reach 1e4 to 1e6, where float32 rounding in any order
    moves a result that cancels to near 0 by more than 5e-3."""
    rng = np.random.default_rng(m + k + n)
    h = max(1, min(64, 2 ** 24 // (k << bits)))
    x = torch.from_numpy(rng.integers(0, 1 << bits, (m, k)).astype(np.int32))
    wi = torch.from_numpy(rng.integers(-h, h, (k, n)).astype(np.float32))
    wf = torch.from_numpy(rng.standard_normal((k, n)).astype(np.float32))
    got = bitserial_matmul(x.to(card), wi.to(card), bits).cpu()
    assert torch.equal(got, (x.long() @ wi.long()).float())
    got = bitserial_matmul(x.to(card), wf.to(card), bits).cpu().double()
    want = bitserial_matmul_ref(x, wf, bits).double()
    terms = x.double().abs() @ wf.double().abs()
    assert ((got - want).abs() <= 5e-3 + 1e-4 * terms).all()


def test_k3_float_w_across_magnitudes(card):
    """K3 with float w whose columns span 1e-20 to 1e20, and with x and
    w at 4-byte offsets (the unaligned copy path): within rtol 1e-4 of
    the summed terms |x| @ |w| of both the plain version and float64 —
    the bf16 split is exact at every magnitude."""
    rng = np.random.default_rng(5)
    m, k, n = 40, 300, 96
    x = rng.integers(0, 256, (m, k)).astype(np.int32)
    w = (rng.standard_normal((k, n))
         * 10.0 ** rng.uniform(-20, 20, n)).astype(np.float32)
    xs = torch.zeros(m * k + 1, dtype=torch.int32)
    ws = torch.zeros(k * n + 1, dtype=torch.float32)
    xs[1:] = torch.from_numpy(x).flatten()
    ws[1:] = torch.from_numpy(w).flatten()
    xd = xs.to(card)[1:].view(m, k)
    wd = ws.to(card)[1:].view(k, n)
    assert xd.is_contiguous() and xd.data_ptr() % 16 != 0
    got = bitserial_matmul(xd, wd, 8).cpu().double()
    terms = torch.from_numpy(np.abs(x).astype(np.float64)
                             @ np.abs(w).astype(np.float64))
    exact = torch.from_numpy(x.astype(np.float64) @ w.astype(np.float64))
    plain = bitserial_matmul_ref(torch.from_numpy(x), torch.from_numpy(w),
                                 8).double()
    assert ((got - exact).abs() <= 1e-4 * terms).all()
    assert ((got - plain).abs() <= 1e-4 * terms).all()


@pytest.mark.parametrize("k", [1, 2, 4, 8])
def test_kernels_on_serve_fused_tables(card, k):
    """The round-trip and serial serve passes' fused tables,
    compile_batch("mac", 8, k): K1 at one word (one row a slot) and at
    8 words, at macro 1 and 8, and K2 at 1 and 8 rows, bit-identical to
    their plain versions."""
    packed = Engine("torch:device=cpu").compile_batch("mac", 8, k).packed
    c = packed.init_mask.shape[1]
    rng = np.random.default_rng(k)
    for words in (1, 8):
        st = torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31, (words, c),
                                           dtype=np.int64).astype(np.int32))
        for macro in (1, 8):
            got = crossbar_run_packed(st.to(card), packed, macro=macro)
            assert torch.equal(got.cpu(),
                               crossbar_run_ref_packed(st, packed, macro))
    for rows in (1, 8):
        _k2_check(card, packed, rows, rows + k)


@pytest.mark.parametrize("words", [1, 33, 45, 300])
def test_k1_on_coscheduled_table(card, words):
    """K1 on the fused co-scheduled table of two N = 32 MACs (C = 855,
    64 ops a cycle), bit-identical to its plain version, at word counts
    around its 32-word block, and with a smaller block."""
    packed = Engine("torch:device=cpu").compile_batch("mac", 32, 2).packed
    c = packed.init_mask.shape[1]
    assert (c, packed.gate_id.shape[1]) == (855, 64)
    assert not kernel_tables(packed, "cpu").held
    rng = np.random.default_rng(words)
    st = torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31, (words, c),
                                       dtype=np.int64).astype(np.int32))
    want = crossbar_run_ref_packed(st, packed)
    assert torch.equal(crossbar_run_packed(st.to(card), packed).cpu(), want)
    assert torch.equal(crossbar_run_packed(st.to(card), packed,
                                           word_block=13).cpu(), want)


def test_k1_long_steps(card):
    """A cycle of 1,100 SETs, then one of 300 ops: steps longer than the
    ring's smallest quarter (64 entries) take a larger ring;
    bit-identical to the plain version."""
    rng = np.random.default_rng(7)
    t, m, c = 3, 300, 1200
    gate = np.zeros((t, m), np.int32)
    gate[1] = 1                                   # NOT
    ins = np.zeros((t, m, 3), np.int32)
    ins[1, :, 0] = rng.integers(0, 600, m)
    out = np.full((t, m), c - 1, np.int32)
    out[1] = 600 + np.arange(m)
    init = np.zeros((t, c), bool)
    init[0, :1100] = True
    packed = packed_from_arrays(gate, ins, out, init)
    st = torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31, (40, c),
                                       dtype=np.int64).astype(np.int32))
    assert torch.equal(crossbar_run_packed(st.to(card), packed).cpu(),
                       crossbar_run_ref_packed(st, packed))


def test_k1_held_table(card):
    """A random table whose cycles read columns they write runs K1's held
    path (all gathers, then the writes), bit-identical to the plain
    version."""
    packed = packed_from_arrays(*held_table())
    c = packed.init_mask.shape[1]
    assert kernel_tables(packed, "cpu").held
    rng = np.random.default_rng(3)
    st = torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31, (70, c),
                                       dtype=np.int64).astype(np.int32))
    assert torch.equal(crossbar_run_packed(st.to(card), packed).cpu(),
                       crossbar_run_ref_packed(st, packed))


def _k2_check(card, packed, rows, seed: int, **kw) -> None:
    """One K2 launch on random {0,1} state, bit-identical to the plain
    version."""
    rng = np.random.default_rng(seed)
    c = packed.init_mask.shape[1]
    bits = torch.from_numpy(rng.integers(0, 2, (rows, c), dtype=np.uint8))
    before = crossbar_run.launches
    got = crossbar_run(bits.to(card), packed, **kw)
    assert crossbar_run.launches == before + 1
    assert torch.equal(got.cpu(), crossbar_run_ref(bits, packed))


@pytest.mark.parametrize("n", [8, 16, 32])
@pytest.mark.parametrize("kind", FAMILIES)
def test_k2_every_family(card, kind, n):
    """K2 on every compiled family at rows straddling its 32-row words
    and its 1,024-row block."""
    packed = compile_cached(kind, n).packed
    for rows in (1, 31, 33, 1000, 4097):
        _k2_check(card, packed, rows, rows + n)


def test_k2_on_coscheduled_table(card):
    """K2 on the fused co-scheduled table of two N = 32 MACs (C = 855,
    not a multiple of 4: byte-wise unpack), at the default block and at
    14 words a block."""
    packed = Engine("torch:device=cpu").compile_batch("mac", 32, 2).packed
    assert packed.init_mask.shape[1] == 855
    for rows in (33, 1000, 4097):
        _k2_check(card, packed, rows, rows)
        _k2_check(card, packed, rows, rows, word_block=14)


@pytest.mark.parametrize("dup", [False, True])
def test_k2_held_table(card, dup):
    """K2's held path (one warp, gathers before the writes), with and
    without two ops of one cycle writing one column."""
    packed = packed_from_arrays(*held_table(dup))
    assert kernel_tables(packed, "cpu").held
    for rows in (1, 70, 1000, 4097):
        _k2_check(card, packed, rows, rows)


def test_k1_and_k2_on_duplicate_write_table(card):
    """Two NOTs write one column: both kernels leave the AND of both
    results, as their plain versions do ([0, 0, 1, 0] on rows (a, b) =
    (0,1), (1,0), (0,0), (1,1) with column 2 at 1)."""
    packed = packed_from_arrays(*dup_write_table())
    bits = torch.zeros((4, 4), dtype=torch.uint8)
    bits[:, 0] = torch.tensor([0, 1, 0, 1])
    bits[:, 1] = torch.tensor([1, 0, 0, 1])
    bits[:, 2] = 1
    got = crossbar_run(bits.to(card), packed).cpu()
    assert got[:, 2].tolist() == [0, 0, 1, 0]
    _k2_check(card, packed, 1000, 1)
    for p in (packed, packed_from_arrays(*held_table(True))):
        rng = np.random.default_rng(2)
        st = torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31,
                                           (70, p.init_mask.shape[1]),
                                           dtype=np.int64).astype(np.int32))
        assert torch.equal(crossbar_run_packed(st.to(card), p).cpu(),
                           crossbar_run_ref_packed(st, p))


def test_k2_unaligned_view(card):
    """A state that starts one byte into its storage (not 16-byte
    aligned) gives the same result as an aligned copy."""
    packed = compile_cached("multpim", 8).packed
    c = packed.init_mask.shape[1]
    rng = np.random.default_rng(4)
    bits = torch.from_numpy(rng.integers(0, 2, (300, c), dtype=np.uint8))
    flat = torch.zeros(300 * c + 1, dtype=torch.uint8, device=card)
    flat[1:] = bits.flatten().to(card)
    view = flat[1:].view(300, c)
    assert view.data_ptr() % 16 != 0
    assert torch.equal(crossbar_run(view, packed).cpu(),
                       crossbar_run_ref(bits, packed))


def test_tables_too_wide_raise_before_launch(card):
    """C + 2 > 4096 columns: both kernels raise ValueError and count no
    launch."""
    c = 4095
    packed = packed_from_arrays(np.array([[2]], np.int32),
                                np.zeros((1, 1, 3), np.int32),
                                np.array([[1]], np.int32),
                                np.zeros((1, c), bool))
    k1, k2 = crossbar_run_packed.launches, crossbar_run.launches
    with pytest.raises(ValueError, match="12-bit"):
        crossbar_run(torch.zeros((40, c), dtype=torch.uint8, device=card),
                     packed)
    with pytest.raises(ValueError, match="12-bit"):
        crossbar_run_packed(torch.zeros((2, c), dtype=torch.int32,
                                        device=card), packed)
    assert (crossbar_run_packed.launches, crossbar_run.launches) == (k1, k2)


def test_linear_on_card(card):
    """Engine.linear on the card: the exact path equals the float64
    oracle of the card's own quantized operands at rtol 1e-6, the K3
    path stays inside its float32 rounding bound (K + n + 3 ulps of
    2 K (2^n - 1)^2, see chip_smoke.py) and launches K3; ragged_linear
    equals a per-segment oracle."""
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((33, 1000)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((1000, 70)).astype(np.float32))
    eng = Engine()
    from repro_torch.pim.quant import quantize
    xq, wq = quantize(x.to(card), 8), quantize(w.to(card), 8, axis=0)
    xq, wq = [t._replace(q=t.q.cpu(), scale=t.scale.cpu()) for t in (xq, wq)]
    xi = xq.q.double() - xq.zero
    wi = wq.q.double() - wq.zero
    oracle = (xi @ wi) * xq.scale.double() * wq.scale.double()
    got = eng.linear(x.to(card), w.to(card), mode="pim")
    assert got.device.type == "cuda"
    torch.testing.assert_close(got.cpu().double(), oracle, rtol=1e-6,
                               atol=0)
    before = bitserial_matmul.launches
    k3 = eng.linear(x.to(card), w.to(card), mode="pim", use_pallas=True)
    assert bitserial_matmul.launches == before + 1
    ulp = float(np.spacing(np.float32(2 * 1000 * 255 ** 2)))
    tol = (1000 + 8 + 3) * ulp * xq.scale.double() * wq.scale.double()
    assert ((k3.cpu().double() - oracle).abs()
            <= tol + 1e-6 * oracle.abs()).all()
    # Tight: the same zero-point formula over K3's plain version on the
    # layer's own operands, within rtol 1e-4 of the summed terms' scale.
    wf = wq.q.float()
    twin = bitserial_matmul_ref(xq.q, wf, 8)
    twin = (twin - (xq.zero * wf.sum(0, keepdim=True)
                    + wq.zero * xq.q.float().sum(1, keepdim=True)
                    - 1000 * xq.zero * wq.zero)) * xq.scale * wq.scale
    terms = (xq.q.double() @ wf.double()) * xq.scale.double() \
        * wq.scale.double()
    assert ((k3.cpu().double() - twin.double()).abs()
            <= 1e-4 * terms).all()
    with pytest.raises(ValueError, match="cuda"):
        eng.linear(x, w, mode="pim")
    counts = [5, 0, 20, 8]
    we = torch.from_numpy(rng.standard_normal((4, 1000, 9)).astype(
        np.float32))
    got = eng.ragged_linear(x.to(card), we.to(card), counts).cpu()
    xq, wq = quantize(x.to(card), 8), quantize(we.to(card), 8)
    xq, wq = [t._replace(q=t.q.cpu(), scale=t.scale.cpu()) for t in (xq, wq)]
    lo = 0
    for e, c in enumerate(counts):
        seg = ((xq.q[lo:lo + c].double() - xq.zero)
               @ (wq.q[e].double() - wq.zero))
        torch.testing.assert_close(
            got[lo:lo + c].double(),
            seg * xq.scale.double() * wq.scale.double(), rtol=1e-6, atol=0)
        lo += c


def test_pim_spans_on_card(card, tmp_path):
    """Engine.linear and ragged_linear on the card under torch.profiler,
    the tracer disabled: the same outputs as untraced; every PIM span
    has its device time, each phase no more than its pim.linear; its
    profiler twin's ts + baseTimeNanoseconds / 1e3 is the span's ts
    within 1 ms; and each span's device time is what the profiler's
    export gives its twin: the kernels, copies and sets launched inside
    it (the launch's correlation id)."""
    import json

    from torch.profiler import ProfilerActivity, profile

    from repro_torch import obs
    g = torch.Generator(device=card).manual_seed(3)
    x = torch.randn(64, 1024, device=card, generator=g)
    w = torch.randn(1024, 512, device=card, generator=g)
    we = torch.randn(4, 1024, 96, device=card, generator=g)
    counts = torch.tensor([20, 0, 30, 14], device=card)
    eng = Engine()
    want = (eng.linear(x, w), eng.ragged_linear(x, we, counts))
    obs.reset_trace()
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            got = (eng.linear(x, w), eng.ragged_linear(x, we, counts))
        events = [e for e in obs.events() if e["ph"] == "X"
                  and e["name"].startswith("pim.")]
    finally:
        obs.reset_trace()
    assert all(torch.equal(a, b) for a, b in zip(want, got))
    path = tmp_path / "prof.json"
    prof.export_chrome_trace(str(path))
    doc = json.loads(path.read_text())
    base_us = doc["baseTimeNanoseconds"] / 1e3
    launches = {e["args"]["correlation"]: e["ts"]
                for e in doc["traceEvents"]
                if e.get("cat") in ("cuda_runtime", "cuda_driver")
                and "correlation" in e.get("args", {})}
    device = [(launches.get(e["args"].get("correlation")), e["dur"])
              for e in doc["traceEvents"]
              if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    twins = {}
    for e in sorted(doc["traceEvents"], key=lambda e: e.get("ts", 0)):
        if e.get("cat") in ("cpu_op", "user_annotation") and \
                e["name"].startswith("pim."):
            us = sum(d for at, d in device if at is not None
                     and e["ts"] <= at <= e["ts"] + e["dur"])
            twins.setdefault(e["name"], []).append((e["ts"], us))
    by_id = {e["id"]: e for e in events}
    names = set()
    for e in events:
        names.add(e["name"])
        us = e["args"]["device_us"]
        assert us > 0, e
        top = by_id.get(e["parent"])
        if top is not None and top["name"].startswith("pim."):
            assert us <= top["args"]["device_us"], (e, top)
        ts, want_us = min(twins[e["name"]],
                          key=lambda t: abs(t[0] + base_us - e["ts"]))
        assert abs(ts + base_us - e["ts"]) < 1000.0, e["name"]
        assert us == pytest.approx(want_us, rel=1e-3, abs=0.5), e["name"]
    assert {"pim.linear", "pim.ragged_linear", "pim.weight",
            "pim.activation", "pim.dispatch", "pim.product",
            "pim.dequant"} <= names


def _serve_trace(n_requests=32, rate=500.0):
    from repro_torch.serve import TrafficConfig, generate
    return generate(TrafficConfig(n_requests=n_requests, rate=rate,
                                  n_bits=8, seed=0))


def test_serve_continuous_on_card(card):
    """Continuous serving on packed torch: every request's tokens equal
    the plain-int reference, and each scheduler step launches K1 once on
    a chain's first pass (mac), twice on every later pass (stage, mac),
    and once more (recomb) when it drains."""
    from repro_torch.serve import ContinuousBatcher, reference_tokens
    eng = Engine("torch:pack=true")
    b = ContinuousBatcher(eng, n_bits=8)
    assert b.resident
    for r in _serve_trace():
        b.queue.submit(r, 0.0)
    b.warmup()
    compiles0 = eng.stats()["compiles"]
    steps = 0
    while not b.idle:
        b._admit(0.0)
        first = b._rex._dev is None
        drains = any(s is not None and s.steps_left == 1 for s in b.slots)
        before = crossbar_run_packed.launches
        b.step()
        want = (1 if first else 2) + (1 if drains else 0)
        assert crossbar_run_packed.launches - before == want
        steps += 1
    assert steps > 0 and len(b.finished_reqs) == 32
    assert eng.stats()["compiles"] == compiles0
    for r in b.finished_reqs:
        assert r.tokens == reference_tokens(r, 8)


@pytest.mark.parametrize("key", ["flip@1e-5@0", "flip@5e-5@0"])
def test_serve_fault_check_on_card(card, key):
    """The fault-checked run on the card: injected flips (through the
    plain PyTorch faulty scan on the card) detected and repaired; the
    tokens bit-exact, zero recompiles, no abort."""
    from repro_torch.faults import get_fault_model
    from repro_torch.serve import run_load
    get_fault_model(key).reset()
    rep = run_load(Engine(f"torch:pack=true,faults={key}"), _serve_trace(),
                   realtime=False, watchdog_s=120)
    assert rep.bit_exact and rep.escaped_tokens == 0
    assert rep.recompiles == 0 and not rep.aborted
    assert rep.n_requests == 32


def test_serve_unpacked_through_k2_on_card(card):
    """torch:pack=false serves on the round-trip path through K2,
    bit-exact."""
    from repro_torch.serve import run_load
    before = (crossbar_run_packed.launches, crossbar_run.launches)
    rep = run_load(Engine("torch:pack=false"), _serve_trace(),
                   realtime=False)
    assert rep.bit_exact and rep.recompiles == 0 and rep.n_requests == 32
    assert crossbar_run.launches - before[1] == rep.passes > 0
    assert crossbar_run_packed.launches == before[0]


@pytest.mark.parametrize("n", [8, 32])
def test_kernels_on_area_tables(card, n):
    """K1 (macro 1 and 8) and K2 on the multpim_area tables, bit-identical
    to their plain versions, and the front door's products exact."""
    packed = compile_cached("multpim_area", n).packed
    c = packed.init_mask.shape[1]
    rng = np.random.default_rng(n)
    for words in (1, 33, 300):
        st = torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31, (words, c),
                                           dtype=np.int64).astype(np.int32))
        got = crossbar_run_packed(st.to(card), packed)
        for macro in (1, 8):
            assert torch.equal(got.cpu(),
                               crossbar_run_ref_packed(st, packed, macro))
    for rows in (1, 33, 1000, 4097):
        _k2_check(card, packed, rows, rows + n)
    a = rng.integers(0, 1 << n, 100, dtype=np.uint64)
    b = rng.integers(0, 1 << n, 100, dtype=np.uint64)
    for spec in ("torch:pack=true", "torch:pack=false"):
        out = Engine(spec).compile("multpim_area", n).run({"a": a, "b": b})
        assert [int(v) for v in out["out"]] == [int(x) * int(y)
                                                for x, y in zip(a, b)]


def test_trace_replay_through_k1_and_k2(card):
    """K1 and K2 equal their plain versions on the fused N = 32 group
    tables; a trace recorded on the card's default engine holds numpy's
    exact products and the host interpreter's replay, and replays
    bit-exact through Engine("torch:pack=true") (one K1 launch an EXEC)
    and Engine("torch:pack=false") (one K2 launch an EXEC)."""
    from repro_torch.device import CommandTrace, DeviceConfig, TraceRecorder
    eng = Engine()
    rec = TraceRecorder(DeviceConfig.parse("1x1x1x2", crossbar=eng.crossbar))
    rng = np.random.default_rng(5)
    rows = 1024
    zeros = np.zeros(rows, dtype=object)
    # Two N = 32 MACs (855 of the crossbar's 1,024 columns; a third
    # would need 1,281) and a heterogeneous pair of multipliers.
    mac = eng.compile_group([("mac", 32, 1, "w1"), ("mac", 32, 1, "w3")])
    mul = eng.compile_group([("multpim", 32, 1, "m"), ("rime", 32, 1, "r")])
    for gex in (mac, mul):
        c = gex.packed.init_mask.shape[1]
        st = torch.from_numpy(rng.integers(
            -2 ** 31, 2 ** 31, (rows // 32, c), dtype=np.int64
        ).astype(np.int32))
        for macro in (1, 8):
            assert torch.equal(
                crossbar_run_packed(st.to(card), gex.packed, macro=macro).cpu(),
                crossbar_run_ref_packed(st, gex.packed, macro))
        bits = torch.from_numpy(rng.integers(0, 2, (rows, c), dtype=np.uint8))
        assert torch.equal(crossbar_run(bits.to(card), gex.packed).cpu(),
                           crossbar_run_ref(bits, gex.packed))
    for _ in range(2):
        pairs = [(rng.integers(0, 1 << 30, rows),
                  rng.integers(0, 1 << 30, rows)) for _ in range(2)]
        out = mac.run([eng.mac_inputs(32, a, b, zeros, zeros)
                       for a, b in pairs], recorder=rec)
        for o, (a, b) in zip(out, pairs):
            s, c = eng.mac_accumulate(32, o)
            assert [int(x) + int(y) for x, y in zip(s, c)] == \
                [int(p) * int(q) for p, q in zip(a, b)]
        ops = [{"a": rng.integers(0, 1 << 32, rows, dtype=np.uint64),
                "b": rng.integers(0, 1 << 32, rows, dtype=np.uint64)}
               for _ in range(2)]
        out = mul.run(ops, recorder=rec)
        for o, op in zip(out, ops):
            assert [int(v) for v in o["out"]] == \
                [int(p) * int(q) for p, q in zip(op["a"], op["b"])]
    back = CommandTrace.loads(rec.trace.dumps())
    execs = len(back.by_kind("EXEC"))
    d2h = len(back.by_kind("D2H"))
    assert back.verify_replay(Engine("numpy")) == d2h == 8
    for spec, counter in (("torch:pack=true", crossbar_run_packed),
                          ("torch:pack=false", crossbar_run)):
        before = counter.launches
        assert back.verify_replay(Engine(spec)) == d2h
        assert counter.launches - before == execs == 4


def test_disk_loaded_entry_through_k1(card, tmp_path, monkeypatch):
    """An entry loaded from the disk cache has the compiled tables, and
    K1 on it is bit-identical to its plain version."""
    from repro_torch.compiler import ProgramCache
    monkeypatch.setenv("REPRO_CACHE_DIR", str(tmp_path))
    cold = ProgramCache(use_disk=True).get_or_compile("multpim", 32)
    loaded = ProgramCache(use_disk=True).get_or_compile("multpim", 32)
    assert loaded.from_disk and not cold.from_disk
    for name in ("gate_id", "in_cols", "out_col", "init_mask"):
        assert np.array_equal(getattr(loaded.packed, name),
                              getattr(cold.packed, name))
    c = loaded.packed.init_mask.shape[1]
    st = torch.from_numpy(np.random.default_rng(1).integers(
        -2 ** 31, 2 ** 31, (300, c), dtype=np.int64).astype(np.int32))
    assert torch.equal(crossbar_run_packed(st.to(card), loaded.packed).cpu(),
                       crossbar_run_ref_packed(st, loaded.packed))


def _pim(cfg, scope):
    import dataclasses
    if scope is None:
        return cfg
    return dataclasses.replace(cfg, pim_linear_mode="pim", pim_linear_bits=8,
                               pim_block_mode=scope)


@pytest.mark.parametrize("arch,scope", [("gemma2-9b", "full"),
                                        ("deepseek-moe-16b", "ffn"),
                                        ("qwen3-8b", None)])
def test_smoke_model_on_card_against_host(card, arch, scope):
    """A smoke model on the card's default engine against the same model
    on the CPU, same parameters: float logits within rtol = atol = 1e-4
    (float32 in other orders), PIM logits within a relative norm of
    1e-3 (a last-bit difference can round to another 8-bit level), and
    the same greedy tokens through the launcher's prefill + decode."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import serve_model
    from repro_torch.models import build_model
    from repro_torch.models.transformer import tree_map
    cfg = _pim(get_config(arch, smoke=True), scope)
    host, dev = Engine("torch:device=cpu"), Engine()
    on_host, on_card = (build_model(cfg, engine=host),
                        build_model(cfg, engine=dev))
    params = on_host.init(torch.Generator().manual_seed(0))
    params_card = tree_map(lambda t: t.to(card), params)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        3, cfg.vocab_size, (2, 12)))
    want, _ = on_host.forward(params, toks)
    got, _ = on_card.forward(params_card, toks.to(card))
    got = got.cpu()
    if scope is None:
        assert torch.allclose(got, want, rtol=1e-4, atol=1e-4)
    else:
        assert float(torch.linalg.norm(got - want)
                     / torch.linalg.norm(want)) <= 1e-3
    a = serve_model(on_host, params, toks[:, :6], host, gen=4, cache_len=16)
    b = serve_model(on_card, params_card, toks[:, :6].to(card), dev, gen=4,
                    cache_len=16)
    assert np.array_equal(a.tokens, b.tokens) and b.recompiles == 0


@pytest.mark.parametrize("scope", [None, "full"])
def test_full_width_gemma2_block_on_card_against_host(card, scope):
    """One local-attention block of gemma2-9b at its published width
    (d_model 3584, 16 x 256 query and 8 KV heads, d_ff 14336, softcap 50)
    over 1 x 16 tokens, on the card against the CPU on the same
    parameters: float within rtol = atol = 1e-4, every projection on the
    PIM path within a relative norm of 1e-3."""
    from repro_torch.configs import get_config
    from repro_torch.models.blocks import apply_block, init_block
    from repro_torch.models.layers import Initializer
    from repro_torch.models.transformer import tree_map
    cfg = _pim(get_config("gemma2-9b"), scope)
    p = init_block(cfg, Initializer(torch.Generator().manual_seed(0)), "l")
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (1, 16, cfg.d_model)).astype(np.float32))
    pos = torch.arange(16)[None]
    want, _ = apply_block(cfg, "l", p, x, pos=pos,
                          engine=Engine("torch:device=cpu"))
    got, _ = apply_block(cfg, "l", tree_map(lambda t: t.to(card), p),
                         x.to(card), pos=pos.to(card), engine=Engine())
    got = got.cpu()
    if scope is None:
        assert torch.allclose(got, want, rtol=1e-4, atol=1e-4)
    else:
        assert float(torch.linalg.norm(got - want)
                     / torch.linalg.norm(want)) <= 1e-3


def _train_batch(cfg, dev, b=4, s=32):
    rng = np.random.default_rng(5)
    return {k: torch.from_numpy(rng.integers(3, cfg.vocab_size, (b, s),
                                             dtype=np.int32)).to(dev)
            for k in ("tokens", "labels")}


@pytest.mark.parametrize("arch,microbatches", [("qwen3-8b", 2),
                                               ("rwkv6-7b", 1)])
def test_train_step_on_card_against_host(card, arch, microbatches):
    """Two AdamW train steps of a smoke model (remat, microbatched for
    qwen3-8b) on the card against the CPU from the same parameters:
    loss within rtol 1e-5, grad_norm 1e-4, the second loss 1e-4 (float32
    sums in other orders; AdamW's first step moves a parameter by about
    sign(g) lr); every state leaf stays on the card."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import make_train_step
    from repro_torch.tree import tree_leaves, tree_map
    cfg = get_config(arch, smoke=True)
    kw = dict(lr=3e-3, warmup_steps=2, total_steps=60)
    out = []
    state = None
    for engine in (Engine("torch:device=cpu"), Engine()):
        model = build_model(cfg, remat=True, engine=engine)
        step, init_fn, _ = make_train_step(model, AdamWConfig(**kw),
                                           microbatches=microbatches)
        if state is None:
            state = init_fn(0)
            host_state = tree_map(lambda t: t.detach().clone()
                                  .requires_grad_(t.requires_grad), state)
        else:
            state = tree_map(lambda t: t.detach().to(card)
                             .requires_grad_(t.requires_grad), host_state)
        mets = []
        for _ in range(2):
            *state, met = step(*state, _train_batch(cfg, model.device))
            mets.append({k: float(v) for k, v in met.items()})
        out.append(mets)
    assert all(t.device.type == "cuda" for t in tree_leaves(state))
    (h0, h1), (c0, c1) = out
    assert c0["loss"] == pytest.approx(h0["loss"], rel=1e-5)
    assert c0["grad_norm"] == pytest.approx(h0["grad_norm"], rel=1e-4)
    assert c0["lr"] == pytest.approx(h0["lr"], rel=1e-6)
    assert c1["loss"] == pytest.approx(h1["loss"], rel=1e-4)


def test_checkpoint_restores_onto_card(card, tmp_path):
    """A tree saved from the card restores onto the card, equal, with
    each leaf's requires_grad."""
    from repro_torch.train import restore_checkpoint, save_checkpoint
    tree = {"w": torch.randn(4, 8, device=card).requires_grad_(),
            "count": torch.tensor(3, dtype=torch.int32, device=card)}
    save_checkpoint(str(tmp_path), 3, tree)
    got, step = restore_checkpoint(str(tmp_path), tree)
    assert step == 3 and got["w"].device.type == "cuda"
    assert got["w"].requires_grad and torch.equal(got["w"], tree["w"])
    assert torch.equal(got["count"], tree["count"])


def test_train_launcher_defaults_to_card(card):
    """Without --pim-backend the launcher trains on the card."""
    from repro_torch.launch import train as launcher
    from repro_torch.tree import tree_leaves
    run = launcher.main(["--arch", "qwen3-8b", "--smoke", "--steps", "3",
                         "--seq-len", "32", "--global-batch", "4",
                         "--microbatches", "2"])
    assert len(run.losses) == 3 and all(np.isfinite(run.losses))
    assert all(t.device.type == "cuda" for t in tree_leaves(run.state[0]))


def _dryrun_against_card(cfg, shape, microbatches=1):
    """A record on the card's own 1 x 1 mesh against real steps: exact
    argument bytes, peak and temp bytes each within 10%."""
    import gc
    from repro_torch.launch.dryrun import cell_record, real_step
    from repro_torch.launch.mesh import make_host_mesh
    rec = cell_record(cfg, shape, make_host_mesh(),
                      microbatches=microbatches)
    assert rec["mesh"] == "1x1" and rec["status"] == "ok"
    gc.collect()
    torch.cuda.empty_cache()
    real = real_step(cfg, shape, microbatches=microbatches, steps=3)
    pd = rec["per_device"]
    assert real["argument_bytes"] == pd["argument_bytes"]
    assert abs(pd["peak_bytes"] - real["peak_bytes"]) <= \
        0.10 * real["peak_bytes"]
    assert abs(pd["temp_bytes"] - real["temp_bytes"]) <= \
        0.10 * real["temp_bytes"]
    return rec, real


def test_dryrun_predicts_card_peak(card):
    """The dry-run's record of rwkv6-7b x long_500k, cut to 8 of its 32
    layers at full width (a shorter test; ``chip_smoke.py`` checks the
    whole depth), on the card's own 1 x 1 mesh: its argument bytes equal
    the bytes of the parameters, states and inputs a real decode builds
    on the card, and its peak and temp bytes are each within 10% of the
    measured ones."""
    from repro_torch.configs import SHAPES, get_config
    cfg = get_config("rwkv6-7b").scaled(n_layers=8)
    shape = next(s for s in SHAPES if s.name == "long_500k")
    _dryrun_against_card(cfg, shape)


def test_dryrun_predicts_card_train_peak(card):
    """A train record: qwen3-8b at full width cut to 4 layers (its units
    traced at 2, 3 and 4 and extrapolated), 2 sequences of 512 tokens in 2
    microbatches, bf16 parameters and float32 AdamW state, against real
    ``make_train_step`` steps on the card: exact argument bytes, peak and
    temp bytes each within 10%."""
    from repro_torch.configs import ShapeSpec, get_config
    cfg = get_config("qwen3-8b").scaled(n_layers=4)
    rec, real = _dryrun_against_card(
        cfg, ShapeSpec("train_512", 512, 2, "train"), microbatches=2)
    assert rec["trace"]["units"] == [2, 3, 4]
    assert np.all(np.isfinite(real["outputs"]))
