"""repro_torch on a CUDA card: K1, K2 and K3 against their plain
PyTorch versions, the engine's packed/unpacked front door and resident
chain against exact integer results, the PIM linear layers against
float64 oracles, and serving (resident through K1, fault-checked,
unpacked through K2) against the plain-int reference tokens. Every test
skips without a card; on one,
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

FAMILIES = ["hajali", "multpim", "multpim_mac", "recomb", "residue", "rime",
            "stage"]


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
