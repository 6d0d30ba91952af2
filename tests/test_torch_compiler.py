"""repro_torch compiler copy: the port's program cache yields exactly the
JAX package's compiled tables, so both packages run the same programs."""
import numpy as np
import pytest

pytest.importorskip("torch")

from repro.compiler.cache import compile_cached as jax_compile  # noqa: E402
from repro_torch.compiler.cache import compile_cached  # noqa: E402

pytestmark = pytest.mark.core


@pytest.mark.parametrize("n", [4, 8, 16, 32])
@pytest.mark.parametrize("kind", ["multpim", "multpim_mac", "stage",
                                  "recomb", "rime", "hajali",
                                  "multpim_area"])
def test_compiled_tables_identical(kind, n):
    """Same cycle count and identical gate_id / in_cols / out_col /
    init_mask as the JAX package's cache entry; the port's entry also
    passes its differential verification."""
    ref = jax_compile(kind, n, verify=False)
    got = compile_cached(kind, n)
    assert got.program.n_cycles == ref.program.n_cycles
    assert got.packed.n_cycles == ref.packed.n_cycles
    for name in ("gate_id", "in_cols", "out_col", "init_mask"):
        a, b = getattr(got.packed, name), getattr(ref.packed, name)
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    assert got.program.input_map == ref.program.input_map
    assert got.program.output_map == ref.program.output_map
    assert got.verified is not None and got.verified.ok


@pytest.mark.parametrize("n", [4, 8, 16])
def test_area_variant_bitexact_and_cheaper(n):
    """MultPIM-Area in the port: bit-exact, fewer memristors, more
    cycles, within the cited N*log2N+23N+3 budget, and the same program
    as the reference's builder."""
    import math

    from repro.core.multpim_area import multpim_area_multiplier as ref_area
    from repro_torch.core.bits import from_bits, to_bits
    from repro_torch.core.executor import run_numpy
    from repro_torch.core.multpim import multpim_multiplier
    from repro_torch.core.multpim_area import multpim_area_multiplier
    pa = multpim_area_multiplier(n)
    pm = multpim_multiplier(n)
    assert pa.n_memristors < pm.n_memristors
    assert pm.n_cycles < pa.n_cycles <= (n * math.ceil(math.log2(n))
                                         + 23 * n + 3)
    ref = ref_area(n)
    assert (pa.n_cycles, pa.n_memristors) == (ref.n_cycles,
                                              ref.n_memristors)
    rng = np.random.default_rng(n)
    a = rng.integers(0, 1 << n, 32)
    b = rng.integers(0, 1 << n, 32)
    out = run_numpy(pa, {"a": to_bits(a, n), "b": to_bits(b, n)})
    got = from_bits(out["out"])
    assert all(int(g) == int(x) * int(y) for g, x, y in zip(got, a, b))
