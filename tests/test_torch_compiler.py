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
                                  "recomb", "rime", "hajali"])
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
