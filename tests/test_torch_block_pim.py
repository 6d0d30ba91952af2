"""repro_torch's full-block PIM path against the JAX package's, on the
CPU: ``pim_proj`` quantizes the same input to the reference's integers
and gives its output; whole models with PIM scopes on (full, ffn, and the
MoE ragged path under ffn) agree with the reference's PIM forward. The
JAX parameters are carried across by ``params_from_numpy``."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as jax_config  # noqa: E402
from repro.models import blocks as jb  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro.pim import quant as jq  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.engine import Engine  # noqa: E402
from repro_torch.models import blocks as tb  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.pim import quant as tq  # noqa: E402

pytestmark = pytest.mark.pim

CPU = Engine("torch:device=cpu")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _np(t):
    return t.detach().cpu().numpy()


def _pim(cfg, block_mode):
    return dataclasses.replace(cfg, pim_linear_mode="pim", pim_linear_bits=8,
                               pim_block_mode=block_mode)


def _models(arch, block_mode, seed):
    jm = jax_build(_pim(jax_config(arch, smoke=True), block_mode))
    jp = jm.init(jax.random.PRNGKey(seed))
    tm = build_model(_pim(get_config(arch, smoke=True), block_mode),
                     engine=CPU)
    return jm, jp, tm, params_from_numpy(jax.tree.map(np.asarray, jp))


def _rel(got, want):
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


@pytest.mark.parametrize("scope,on", [("attn", True), ("ffn", True),
                                      ("attn", False)])
def test_pim_proj_quantizes_like_the_reference(scope, on):
    """On the same (2, 5, 64) input and (64, 48) weight: the activation's
    and the per-column weight's 8-bit integers equal the reference's bit
    for bit, and the projection equals the reference's to float32
    rounding (rtol 1e-6: both take the exact integer product and the same
    two scale multiplies). With the scope off it is the plain product."""
    mode = "full" if on else "none"
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32)
    w = rng.standard_normal((64, 48)).astype(np.float32)
    jcfg = _pim(jax_config("gemma2-9b", smoke=True), mode)
    tcfg = _pim(get_config("gemma2-9b", smoke=True), mode)
    for axis, a in ((None, x.reshape(-1, 64)), (0, w)):
        assert np.array_equal(_np(tq.quantize(_t(a), 8, axis=axis).q),
                              np.asarray(jq.quantize(a, 8, axis=axis).q))
    got = _np(tb.pim_proj(tcfg, _t(x), _t(w), scope=scope, engine=CPU))
    want = np.asarray(jb.pim_proj(jcfg, x, w, scope=scope))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    if not on:
        np.testing.assert_allclose(got, x @ w, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("arch,block_mode", [
    ("gemma2-9b", "full"), ("whisper-small", "full"), ("qwen3-8b", "full"),
    ("gemma2-9b", "ffn"), ("deepseek-moe-16b", "ffn"),
    ("recurrentgemma-9b", "ffn")])
def test_pim_forward_matches_reference(arch, block_mode):
    """Every projection of the scopes quantized: the logits within a
    relative norm of 1e-3 of the reference's PIM forward, and the same
    greedy token at every position. (Float32 activations that differ in
    the last bit can round to another 8-bit level, so agreement is to the
    quantization step, not to float32 rounding.)"""
    jm, jp, tm, tp = _models(arch, block_mode, 0)
    toks = np.random.default_rng(0).integers(3, jm.cfg.vocab_size, (2, 8))
    kw, tkw = {}, {}
    if jm.cfg.family == "encdec":
        fr = np.random.default_rng(7).standard_normal(
            (2, jm.cfg.enc_frames, jm.cfg.d_model)).astype(np.float32)
        kw["enc_frames"], tkw["enc_frames"] = jnp.asarray(fr), _t(fr)
    want, _ = jm.forward(jp, jnp.asarray(toks), **kw)
    got, _ = tm.forward(tp, _t(toks), **tkw)
    want, got = np.asarray(want), _np(got)
    assert np.isfinite(got).all()
    assert _rel(got, want) <= 1e-3
    assert np.array_equal(got.argmax(-1), want.argmax(-1))


def test_full_block_forward_close_to_float():
    """tests/test_block_pim.py's bound on the port: with every
    projection quantized the logits stay within 8% of the float model's."""
    cfg = _pim(get_config("gemma2-9b", smoke=True), "full")
    m = build_model(cfg, engine=CPU)
    params = m.init(0)
    toks = _t(np.random.default_rng(0).integers(3, cfg.vocab_size, (2, 8)))
    lp, _ = m.forward(params, toks)
    mf = build_model(dataclasses.replace(cfg, pim_linear_mode="off",
                                         pim_block_mode="none"), engine=CPU)
    lf, _ = mf.forward(params, toks)
    rel = float(torch.linalg.norm(lp - lf) / torch.linalg.norm(lf))
    assert np.isfinite(rel) and rel < 0.08, rel


def test_ffn_scope_leaves_attention_dense():
    """tests/test_block_pim.py:144 on the port: ffn-scope logits differ
    from the full-block model's on the same parameters."""
    tm_ffn = build_model(_pim(get_config("gemma2-9b", smoke=True), "ffn"),
                         engine=CPU)
    tm_full = build_model(_pim(get_config("gemma2-9b", smoke=True), "full"),
                          engine=CPU)
    params = tm_ffn.init(1)
    toks = _t(np.random.default_rng(1).integers(3, 256, (1, 6)))
    l_ffn, _ = tm_ffn.forward(params, toks)
    l_full, _ = tm_full.forward(params, toks)
    assert float((l_ffn - l_full).abs().max()) > 0


def test_moe_ffn_scope_runs_the_ragged_path_like_the_reference():
    """tests/test_block_pim.py:177 on the port, and one MoE block's
    expert FFN under the ffn scope equal to the reference's (rtol/atol
    1e-5): the ragged PIM product is exact integers on both sides."""
    cfg = _pim(jax_config("deepseek-moe-16b", smoke=True), "ffn")
    p = jb.init_moe_block(cfg, jb.Initializer(jax.random.PRNGKey(0)))
    x = np.random.default_rng(2).standard_normal(
        (2, 4, cfg.d_model)).astype(np.float32)
    tcfg = _pim(get_config("deepseek-moe-16b", smoke=True), "ffn")
    got = tb.moe_ffn(tcfg, params_from_numpy(jax.tree.map(np.asarray, p)),
                     _t(x), engine=CPU)
    assert bool(torch.isfinite(got).all())
    np.testing.assert_allclose(_np(got), np.asarray(jb.moe_ffn(cfg, p, x)),
                               rtol=1e-5, atol=1e-5)
