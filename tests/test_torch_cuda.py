"""repro_torch on a CUDA card: K1, K2 and K3 against their plain
PyTorch versions, the engine's packed/unpacked front door and resident
chain against exact integer results, and the PIM linear layers against
float64 oracles. Every test skips without a card; on one,
run ``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py``
(this file imports no JAX, so it runs where JAX is not installed)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.compiler.cache import compile_cached  # noqa: E402
from repro_torch.engine import Engine  # noqa: E402
from repro_torch.kernels.bitserial_matmul import bitserial_matmul  # noqa: E402
from repro_torch.kernels.crossbar_step import (  # noqa: E402
    crossbar_run, crossbar_run_packed)
from repro_torch.kernels.ref import (  # noqa: E402
    bitserial_matmul_ref, crossbar_run_ref, crossbar_run_ref_packed)

pytestmark = pytest.mark.cuda


@pytest.fixture()
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.parametrize("kind,n", [("multpim", 8), ("multpim_mac", 8),
                                    ("rime", 8), ("stage", 8)])
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
