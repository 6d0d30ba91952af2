"""repro_torch PIM linear layers against the JAX package's, on the CPU:
K3's plain version against the reference's Pallas kernel (interpret
mode), quantization, the exact integer products, ``Engine.linear`` in
all three modes (with and without K3), ``ragged_linear``, the planner
and ``pim_linear_apply``. Inputs are made with numpy from a seed and
handed to both packages; each tolerance is stated with its reason."""
import dataclasses
import gc

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config  # noqa: E402
from repro.engine import Engine as JaxEngine  # noqa: E402
from repro.kernels.ops import bitserial_matmul as jax_bitserial  # noqa: E402
from repro.kernels.ref import (  # noqa: E402
    bitserial_matmul_ref as jax_bitserial_ref)
from repro.pim import planner as jax_planner  # noqa: E402
from repro.pim import quant as jq  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.convert import qtensor_from_arrays  # noqa: E402
from repro_torch.engine import Engine  # noqa: E402
from repro_torch.kernels import bitserial_matmul, bitserial_matmul_ref  # noqa: E402
from repro_torch.pim import (PIMLinearSpec, gemms_from_config,  # noqa: E402
                             pim_linear_apply, plan_block, plan_model)
from repro_torch.pim import quant as tq  # noqa: E402

pytestmark = pytest.mark.pim

CPU = "torch:device=cpu"


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _np(t):
    return t.detach().cpu().numpy()


def _xw(seed, m, k, n):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((m, k)).astype(np.float32),
            rng.standard_normal((k, n)).astype(np.float32))


# ------------------------------------------------------------------ K3 ----
@pytest.mark.parametrize("m,k,n,bits", [
    (32, 64, 16, 8), (100, 96, 60, 8), (17, 130, 33, 4), (64, 64, 64, 2)])
def test_bitserial_twin_matches_pallas_kernel(m, k, n, bits):
    """The reference's sweep: float w, rtol 1e-4 / atol 5e-3 as in its
    own test (both sum in float32, in different orders); the twin equals
    the reference's plain version within float32 rounding too."""
    rng = np.random.default_rng(m * k)
    x = rng.integers(0, 1 << bits, (m, k)).astype(np.int32)
    w = rng.standard_normal((k, n)).astype(np.float32)
    got = _np(bitserial_matmul(_t(x), _t(w), bits))
    pallas = np.asarray(jax_bitserial(jnp.asarray(x), jnp.asarray(w), bits))
    plain = np.asarray(jax_bitserial_ref(jnp.asarray(x), jnp.asarray(w),
                                         bits))
    np.testing.assert_allclose(got, pallas, rtol=1e-4, atol=5e-3)
    np.testing.assert_allclose(got, plain, rtol=1e-5, atol=1e-4)
    exact = x.astype(np.float64) @ w.astype(np.float64)
    np.testing.assert_allclose(got, exact, rtol=3e-4, atol=5e-3)


def test_bitserial_twin_int_weights_bit_exact():
    """Integer weights inside the exact range: the twin, the Pallas
    kernel and the int64 product agree bit for bit."""
    rng = np.random.default_rng(7)
    x = rng.integers(0, 256, (50, 80)).astype(np.int32)
    w = rng.integers(-64, 64, (80, 30)).astype(np.float32)
    got = _np(bitserial_matmul(_t(x), _t(w), 8))
    pallas = np.asarray(jax_bitserial(jnp.asarray(x), jnp.asarray(w), 8))
    exact = x.astype(np.int64) @ w.astype(np.int64)
    assert (got == exact).all() and (pallas == exact).all()
    # only the n_bits low planes count, as in the plane form
    wide = x + (1 << 8) * rng.integers(0, 4, x.shape).astype(np.int32)
    assert (_np(bitserial_matmul_ref(_t(wide), _t(w), 8)) == exact).all()


def test_bitserial_wrapper_checks():
    """The wrapper keeps the reference's K * 2^n < 2^24 assertion and
    refuses wrong types, shapes, layouts and mixed devices; CPU tensors
    take the plain version and launch nothing."""
    x = torch.zeros((4, 8), dtype=torch.int32)
    w = torch.zeros((8, 3), dtype=torch.float32)
    before = bitserial_matmul.launches
    assert torch.equal(bitserial_matmul(x, w), torch.zeros(4, 3))
    assert bitserial_matmul.launches == before
    with pytest.raises(AssertionError, match="exactness"):
        bitserial_matmul(torch.zeros((1, 1 << 16), dtype=torch.int32),
                         torch.zeros((1 << 16, 1)), 8)
    with pytest.raises(ValueError, match="int32"):
        bitserial_matmul(x.long(), w)
    with pytest.raises(ValueError, match="int32"):
        bitserial_matmul(x, w.double())
    with pytest.raises(ValueError, match=r"\(M, K\)"):
        bitserial_matmul(x, w.T.contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        bitserial_matmul(x, torch.zeros((3, 8)).T)
    with pytest.raises(ValueError):
        bitserial_matmul(x, w.to("meta"))


# ------------------------------------------------------------ quantize ----
def test_quantize_dequantize_bit_identical():
    """Per-tensor and per-column quantization, including exact .5 ties
    (amax 127 makes the scale exactly 1, so x/scale lands on the ties;
    both packages round half to even)."""
    rng = np.random.default_rng(3)
    ties = np.array([127.0, 0.5, 1.5, 2.5, -0.5, -2.5, -126.5, 3.5],
                    np.float32)
    cases = [rng.standard_normal((16, 40)).astype(np.float32),
             np.tile(ties[:, None], (1, 5)),
             (rng.standard_normal((7, 9)) * 1e-9).astype(np.float32)]
    for x in cases:
        for axis in (None, 0):
            for bits in (4, 8):
                ref = jq.quantize(jnp.asarray(x), bits, axis=axis)
                got = tq.quantize(_t(x), bits, axis=axis)
                assert got.q.dtype == torch.int32
                np.testing.assert_array_equal(_np(got.q), np.asarray(ref.q))
                np.testing.assert_array_equal(_np(got.scale),
                                              np.asarray(ref.scale))
                assert (got.n_bits, got.zero) == (ref.n_bits, ref.zero)
                np.testing.assert_array_equal(
                    _np(tq.dequantize(got)), np.asarray(jq.dequantize(ref)))
    q = tq.quantize(_t(np.tile(ties[:, None], (1, 2))), 8).q[:, 0]
    assert _np(q).tolist() == [255, 128, 130, 130, 128, 126, 2, 132]


def test_qmatmul_exact_bit_identical_at_model_width():
    """K = 4096: the reference's own quantized operands, carried over
    with qtensor_from_arrays, give the identical float32 result; so does
    the port's own quantize; and both equal the float64 oracle at
    rtol 1e-6 (the reference's model-width regression tolerance: the
    only rounding is the final int32 -> float32 and two scale products)."""
    x, w = _xw(11, 8, 4096, 24)
    xq = jq.quantize(jnp.asarray(x), 8)
    wq = jq.quantize(jnp.asarray(w), 8, axis=0)
    want = np.asarray(jq.qmatmul_exact(xq, wq))
    txq = qtensor_from_arrays(np.asarray(xq.q), np.asarray(xq.scale), 8,
                              xq.zero)
    twq = qtensor_from_arrays(np.asarray(wq.q), np.asarray(wq.scale), 8,
                              wq.zero)
    np.testing.assert_array_equal(_np(tq.qmatmul_exact(txq, twq)), want)
    own = tq.qmatmul_exact(tq.quantize(_t(x), 8),
                           tq.quantize(_t(w), 8, axis=0))
    np.testing.assert_array_equal(_np(own), want)
    xi = np.asarray(xq.q, np.int64) - xq.zero
    wi = np.asarray(wq.q, np.int64) - wq.zero
    oracle = ((xi @ wi).astype(np.float64)
              * np.asarray(xq.scale, np.float64)
              * np.asarray(wq.scale, np.float64))
    np.testing.assert_allclose(want, oracle, rtol=1e-6)
    with pytest.raises(ValueError, match="2\\^53"):
        tq.qmatmul_exact(txq._replace(n_bits=30),
                         twq._replace(n_bits=30))
    with pytest.raises(ValueError, match="outside"):
        qtensor_from_arrays(np.array([256]), 1.0, 8, 128)


def _counts(rng, experts, total):
    return rng.multinomial(total, np.ones(experts) / experts).astype(
        np.int32)


def test_qragged_matmul_exact_bit_identical():
    """Ragged per-expert integer products at K = 2048, with an empty
    expert segment, bit-identical to the reference (counts sum to T,
    as the reference assumes); rows past sum(counts) are zero."""
    rng = np.random.default_rng(5)
    T, D, F, E = 40, 2048, 12, 5
    counts = _counts(rng, E, T)
    counts[1] += counts[2]
    counts[2] = 0
    xs = rng.standard_normal((T, D)).astype(np.float32)
    we = rng.standard_normal((E, D, F)).astype(np.float32)
    xq, wq = jq.quantize(jnp.asarray(xs), 8), jq.quantize(jnp.asarray(we), 8)
    want = np.asarray(jq.qragged_matmul_exact(xq, wq, jnp.asarray(counts)))
    txq, twq = tq.quantize(_t(xs), 8), tq.quantize(_t(we), 8)
    got = tq.qragged_matmul_exact(txq, twq, _t(counts))
    np.testing.assert_array_equal(_np(got), want)
    short = counts.copy()
    short[-1] -= 3
    part = _np(tq.qragged_matmul_exact(txq, twq, short.tolist()))
    np.testing.assert_array_equal(part[:T - 3], want[:T - 3])
    assert (part[T - 3:] == 0).all()


# --------------------------------------------------------- Engine.linear ----
@pytest.mark.parametrize("mode", ["float", "fake"])
def test_linear_float_and_fake_modes(mode):
    """float and fake modes: rtol 1e-5 (float32 products, the BLAS
    orders of the two packages differ); a bias and leading batch dims
    pass through."""
    x, w = _xw(1, 12, 96, 40)
    x3 = x.reshape(3, 4, 96)
    b = np.linspace(-1, 1, 40).astype(np.float32)
    want = np.asarray(JaxEngine().linear(jnp.asarray(x3), jnp.asarray(w),
                                         jnp.asarray(b), mode=mode))
    got = _np(Engine(CPU).linear(_t(x3), _t(w), _t(b), mode=mode))
    assert got.shape == want.shape == (3, 4, 40)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_linear_pim_exact_path_bit_identical_at_model_width():
    """mode=pim without K3 at K = 4096 is the exact integer path: the
    same float32 bits as the reference."""
    x, w = _xw(2, 6, 4096, 20)
    want = np.asarray(JaxEngine().linear(jnp.asarray(x), jnp.asarray(w),
                                         mode="pim"))
    got = _np(Engine(CPU).linear(_t(x), _t(w), mode="pim"))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("k", [64, 256])
def test_linear_pim_kernel_path_bit_identical_in_exact_range(k):
    """use_pallas=True inside the exact range, K (2^8 - 1)^2 < 2^24
    (K <= 258): both packages' float32 bit-plane products are exact, so
    the layers agree bit for bit, with each other and with the exact
    integer path."""
    x, w = _xw(k, 16, k, 24)
    want = np.asarray(JaxEngine().linear(jnp.asarray(x), jnp.asarray(w),
                                         mode="pim", use_pallas=True))
    eng = Engine(CPU)
    got = _np(eng.linear(_t(x), _t(w), mode="pim", use_pallas=True))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, _np(eng.linear(_t(x), _t(w), mode="pim")))


def test_linear_pim_kernel_path_pins_reference_caveat():
    """At K = 4096 the float32 bit-plane product rounds (K (2^8 - 1)^2 >
    2^24) in the reference as in the port. The port mirrors, not fixes,
    that: its use_pallas=True error against the exact path is at most
    twice the reference's own on the same inputs, and nonzero."""
    x, w = _xw(0, 8, 4096, 32)
    jeng = JaxEngine()
    ref_exact = np.asarray(jeng.linear(jnp.asarray(x), jnp.asarray(w),
                                       mode="pim"), np.float64)
    ref_k3 = np.asarray(jeng.linear(jnp.asarray(x), jnp.asarray(w),
                                    mode="pim", use_pallas=True), np.float64)
    eng = Engine(CPU)
    exact = _np(eng.linear(_t(x), _t(w), mode="pim")).astype(np.float64)
    k3 = _np(eng.linear(_t(x), _t(w), mode="pim",
                        use_pallas=True)).astype(np.float64)
    np.testing.assert_array_equal(exact, ref_exact)
    ref_err = np.abs(ref_k3 - ref_exact).max()
    err = np.abs(k3 - exact).max()
    assert ref_err > 0
    assert err <= 2 * ref_err
    assert err <= 1e-3 * np.abs(exact).max()


def _fresh(x, w, bits=8):
    """The PIM product with both operands quantized anew."""
    return tq.qmatmul_exact(tq.quantize(x, bits),
                            tq.quantize(w, bits, axis=0))


def _weight_cache():
    """(hits, misses) of the PIM weight cache so far."""
    return (obs.counter("pim.weight_cache.hit").value,
            obs.counter("pim.weight_cache.miss").value)


@pytest.mark.parametrize("case", ["same", "same12", "views", "copy_",
                                  "add_", "rebuilt", "grad", "inference"])
def test_linear_pim_keeps_each_weight_quantized(case):
    """mode=pim keeps a weight's quantization across calls: every output
    equals both operands quantized anew, bit for bit. ``same``: three
    calls on one weight, one miss then hits (``same12``: at 12 bits, the
    levels kept as int16); ``views``: fresh ``stack[i]``
    views of a stacked weight each round, as the model passes them;
    ``copy_``/``add_``: an in-place write into one unit of the stack
    moves the whole stack's version, so every unit is quantized anew and
    the written one gives its new values' product; ``rebuilt``: a weight
    freed and rebuilt from another seed at the same shape never hits;
    ``grad``/``inference``: with autograd recording for ``w``, or an
    inference tensor, nothing is kept or looked up."""
    eng = Engine(CPU)
    g = torch.Generator().manual_seed(3)
    x = torch.randn(5, 48, generator=g) * 2
    stack = torch.randn(3, 48, 24, generator=g)
    before = _weight_cache()

    def call(w, bits=8):
        y = eng.linear(x, w, mode="pim", n_bits=bits)
        assert torch.equal(y, _fresh(x, w.detach(), bits))
        return y

    if case in ("same", "same12"):
        w = stack[0].clone()
        for _ in range(3):
            call(w, 12 if case == "same12" else 8)
        (kept,) = tq._KEPT[w].values()
        assert kept[1].q.dtype == (torch.int16 if case == "same12"
                                   else torch.uint8)
        want = (2, 1)
    elif case == "views":
        for _ in range(3):
            for i in range(3):
                call(stack[i])
        want = (6, 3)
    elif case in ("copy_", "add_"):
        old = [call(stack[i]) for i in range(3)]
        if case == "copy_":
            stack[1].copy_(torch.randn(48, 24, generator=g))
        else:
            stack[1].add_(0.75)
        new = [call(stack[i]) for i in range(3)]
        assert not torch.equal(new[1], old[1])
        assert torch.equal(new[0], old[0]) and torch.equal(new[2], old[2])
        want = (0, 6)
    elif case == "rebuilt":
        for seed in (4, 5, 6):
            w = torch.randn(48, 24, generator=torch.Generator().manual_seed(
                seed))
            call(w)
            del w
            gc.collect()
        want = (0, 3)
    elif case == "grad":
        w = stack[0].clone().requires_grad_()
        for _ in range(2):
            call(w)
        want = (0, 0)
    else:
        with torch.inference_mode():
            w = stack[0].clone()
            for _ in range(2):
                call(w)
        want = (0, 0)
    hits, misses = _weight_cache()
    assert (hits - before[0], misses - before[1]) == want


def test_linear_refuses_operands_off_the_engine_device():
    """The layer computes on the device of its operands, which must be
    the engine backend's: it never moves them itself."""
    eng = Engine(CPU)
    x = torch.ones((2, 4))
    w = torch.ones((4, 3))
    with pytest.raises(ValueError, match="runs on cpu"):
        eng.linear(x.to("meta"), w.to("meta"), mode="pim")
    with pytest.raises(ValueError, match="runs on cpu"):
        eng.ragged_linear(x.to("meta"), w[None].to("meta"), [2])
    with pytest.raises(ValueError, match="int"):
        eng.linear(x, w, mode="int")
    assert eng.linear(x.numpy(), w.numpy(), mode="float").shape == (2, 3)


@pytest.mark.parametrize("mode", ["pim", "float", "fake"])
def test_ragged_linear_matches_reference(mode):
    """MoE grouped GEMM: pim bit-identical (exact integers); float and
    fake at rtol 1e-5 (float32 sums in different orders)."""
    rng = np.random.default_rng(9)
    T, D, F, E = 36, 256, 10, 6
    counts = _counts(rng, E, T)
    xs = rng.standard_normal((T, D)).astype(np.float32)
    we = rng.standard_normal((E, D, F)).astype(np.float32)
    want = np.asarray(JaxEngine().ragged_linear(
        jnp.asarray(xs), jnp.asarray(we), jnp.asarray(counts), mode=mode))
    got = _np(Engine(CPU).ragged_linear(_t(xs), _t(we), _t(counts),
                                        mode=mode))
    if mode == "pim":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_pim_linear_apply_and_spec(monkeypatch):
    """pim_linear_apply routes through the shared engine's linear (here
    a CPU engine stands in for the card's), and the spec's cost and
    inventory record equal the reference's."""
    import repro_torch.engine.engine as engine_mod
    from repro.pim import PIMLinearSpec as JaxSpec
    monkeypatch.setattr(engine_mod, "_DEFAULT", Engine(CPU))
    x, w = _xw(4, 5, 64, 48)
    for mode, use_k3 in (("pim", False), ("pim", True), ("fake", False)):
        spec = PIMLinearSpec(64, 48, mode=mode, use_pallas=use_k3)
        got = _np(pim_linear_apply(spec, _t(x), _t(w)))
        want = np.asarray(JaxEngine().linear(
            jnp.asarray(x), jnp.asarray(w), mode=mode, use_pallas=use_k3))
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    spec, jspec = PIMLinearSpec(4096, 11008), JaxSpec(4096, 11008)
    assert spec.cost(256).as_dict() == jspec.cost(256).as_dict()
    assert vars(spec.as_block_linear()) == vars(jspec.as_block_linear())


# -------------------------------------------------------------- planner ----
@pytest.mark.parametrize("arch", ["deepseek-7b", "deepseek-moe-16b"])
def test_plan_model_matches_reference(arch):
    """plan_model over gemms_from_config of the reference's own config
    object (duck-typed): identical GEMM inventory and totals."""
    cfg = get_config(arch)
    gemms = gemms_from_config(cfg, batch_tokens=1)
    jgemms = jax_planner.gemms_from_config(cfg, batch_tokens=1)
    assert [vars(g) for g in gemms] == [vars(g) for g in jgemms]
    plan = plan_model(gemms, n_bits=8)
    ref = jax_planner.plan_model(jgemms, n_bits=8)
    for name in ("total_cycles", "total_cycles_floatpim",
                 "total_memristors", "total_crossbars"):
        assert getattr(plan, name) == getattr(ref, name), name
    assert plan.per_gemm == ref.per_gemm
    assert plan.summary() == ref.summary()


def test_plan_block_matches_reference():
    """The full-block planner on the port's co-scheduling (compile_group,
    group_counts) gives the reference's groups and cycles per token."""
    cfg = dataclasses.replace(get_config("gemma2-9b", smoke=True),
                              pim_linear_mode="pim", pim_linear_bits=8,
                              pim_block_mode="full")
    plan = plan_block(cfg, Engine(CPU))
    ref = jax_planner.plan_block(cfg, JaxEngine())
    assert plan.scope_metrics() == ref.scope_metrics()
    assert plan.cycles_per_token == ref.cycles_per_token
    assert plan.summary() == ref.summary()
