"""repro_torch on a CUDA card: K1 and K2 against their plain PyTorch
versions, and the engine's packed/unpacked front door and resident chain
against exact integer results. Every test skips without a card; on one,
run ``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py``
(this file imports no JAX, so it runs where JAX is not installed)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.compiler.cache import compile_cached  # noqa: E402
from repro_torch.engine import Engine  # noqa: E402
from repro_torch.kernels.crossbar_step import (  # noqa: E402
    crossbar_run, crossbar_run_packed)
from repro_torch.kernels.ref import (  # noqa: E402
    crossbar_run_ref, crossbar_run_ref_packed)

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
