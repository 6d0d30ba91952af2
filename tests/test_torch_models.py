"""repro_torch's model zoo against the JAX package's, on the CPU: the
layers and attention functions on the same numpy inputs, then every
smoke architecture's forward logits and loss, prefill against decode,
the windowed ring buffer, whisper's cross-attention and the MoE dispatch,
with the JAX parameters carried across by ``params_from_numpy``. Each
tolerance is stated with its reason: both packages compute in float32,
in different summation orders, so agreement is to float32 rounding
(about 1e-6 relative), never bit for bit."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import ARCHS, get_config as jax_config  # noqa: E402
from repro.models import attention as ja  # noqa: E402
from repro.models import blocks as jb  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro.models import layers as jl  # noqa: E402
from repro.models import stack_plan as jax_stack_plan  # noqa: E402
from repro.models.transformer import encode as jax_encode  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import (decode_state_from_numpy,  # noqa: E402
                                 params_from_numpy)
from repro_torch.engine import Engine  # noqa: E402
from repro_torch.models import attention as ta  # noqa: E402
from repro_torch.models import blocks as tb  # noqa: E402
from repro_torch.models import build_model, stack_plan  # noqa: E402
from repro_torch.models import layers as tl  # noqa: E402
from repro_torch.models.transformer import encode, tree_map  # noqa: E402
from repro_torch.train import make_prefill, make_serve_step  # noqa: E402

pytestmark = pytest.mark.models

CPU = Engine("torch:device=cpu")
# Logit tolerance for whole models: float32 sums in another order over a
# few layers of width 64 differ by a few 1e-6 on logits of size ~10.
LOGITS_TOL = dict(rtol=1e-5, atol=2e-5)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _np(t):
    return t.detach().cpu().numpy()


def _carry(jax_tree):
    """A JAX parameter tree as the port's, on the CPU."""
    return params_from_numpy(jax.tree.map(np.asarray, jax_tree))


def _batch(cfg, b=2, s=16):
    """tests/test_models.py::_batch, as numpy."""
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(3, cfg.vocab_size, (b, s)),
             "labels": rng.integers(3, cfg.vocab_size, (b, s))}
    if cfg.family == "vlm":
        batch["patches"] = rng.standard_normal(
            (b, cfg.n_patches, cfg.d_model)).astype(np.float32)
    if cfg.family == "encdec":
        batch["frames"] = rng.standard_normal(
            (b, cfg.enc_frames, cfg.d_model)).astype(np.float32)
    return batch


def _extra(cfg, batch, conv):
    kw = {}
    if cfg.family == "vlm":
        kw["extra_embed"] = conv(batch["patches"])
    if cfg.family == "encdec":
        kw["enc_frames"] = conv(batch["frames"])
    return kw


def _pair(arch, seed):
    """The reference's smoke model and its JAX parameters, the port's
    model on the CPU and the same parameters carried across."""
    jm = jax_build(jax_config(arch, smoke=True))
    jp = jm.init(jax.random.PRNGKey(seed))
    return jm, jp, build_model(get_config(arch, smoke=True), engine=CPU), \
        _carry(jp)


# --------------------------------------------------------------- layers ----
def test_layers_match_reference():
    """rms_norm, layer_norm, softcap, rope, swiglu and the tanh gelu on
    the same inputs: float32 elementwise ops, rtol 1e-6 (rope's cos/sin
    of angles up to 40 rad: atol 1e-5)."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 5, 3, 8)).astype(np.float32)
    w = rng.standard_normal(8).astype(np.float32)
    b = rng.standard_normal(8).astype(np.float32)
    pos = rng.integers(0, 40, (2, 5))
    close = dict(rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(_np(tl.rms_norm(_t(x), _t(w))),
                               np.asarray(jl.rms_norm(x, w)), **close)
    np.testing.assert_allclose(_np(tl.layer_norm(_t(x), _t(w), _t(b))),
                               np.asarray(jl.layer_norm(x, w, b)), **close)
    for cap in (None, 5.0):
        np.testing.assert_allclose(_np(tl.softcap(_t(x * 9), cap)),
                                   np.asarray(jl.softcap(x * 9, cap)),
                                   **close)
    np.testing.assert_allclose(_np(tl.rope(_t(x), _t(pos))),
                               np.asarray(jl.rope(x, pos)),
                               rtol=1e-5, atol=1e-5)
    x2 = rng.standard_normal((6, 8)).astype(np.float32)
    w1, w3 = (rng.standard_normal((8, 16)).astype(np.float32)
              for _ in range(2))
    w2 = rng.standard_normal((16, 8)).astype(np.float32)
    np.testing.assert_allclose(
        _np(tl.swiglu(_t(x2), _t(w1), _t(w3), _t(w2))),
        np.asarray(jl.swiglu(x2, w1, w3, w2)), rtol=1e-5, atol=1e-5)
    # jax.nn.gelu's default is the tanh approximation.
    np.testing.assert_allclose(
        _np(tl.gelu_mlp(_t(x2), _t(w1), _t(w2))),
        np.asarray(jl.gelu_mlp(x2, w1, w2)), rtol=1e-5, atol=1e-5)


def test_initializer_is_seeded_and_scaled():
    """The port's Initializer cannot reproduce jax.random; it is
    deterministic per generator seed, and draws with the asked scale."""
    def draw(seed):
        ini = tl.Initializer(torch.Generator().manual_seed(seed))
        return ini(256, 64, scale=0.5), ini.zeros(3)
    a, z = draw(0)
    b, _ = draw(0)
    assert torch.equal(a, b) and not torch.equal(a, draw(1)[0])
    assert torch.equal(z, torch.zeros(3))
    assert abs(float(a.std()) - 0.5) < 0.02
    d = tl.dense_init(torch.Generator().manual_seed(0), 400, 30)
    assert d.shape == (400, 30) and abs(float(d.std()) - 0.05) < 0.005


# ------------------------------------------------------------ attention ----
@pytest.mark.parametrize("causal,window,cap", [(True, 300, 50.0),
                                               (True, None, None),
                                               (False, None, 30.0)])
def test_dense_and_flash_attend_match_reference(causal, window, cap):
    """s = t = 1100: three 512-blocks with padding on both axes, GQA
    (4 query heads over 2 KV heads). _flash_attend is called directly;
    rtol/atol 1e-5 (float32 softmax sums in other orders)."""
    rng = np.random.default_rng(2)
    q = rng.standard_normal((1, 1100, 4, 16)).astype(np.float32)
    k = rng.standard_normal((1, 1100, 2, 16)).astype(np.float32)
    v = rng.standard_normal((1, 1100, 2, 16)).astype(np.float32)
    kw = dict(causal=causal, window=window, cap=cap, q_offset=0)
    for port_fn, ref_fn in ((ta._dense_attend, ja._dense_attend),
                            (ta._flash_attend, ja._flash_attend)):
        got = _np(port_fn(_t(q), _t(k), _t(v), **kw))
        want = np.asarray(ref_fn(q, k, v, **kw))
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    # attend dispatches 1100 x 1100 to the blockwise path, as the
    # reference does (above FLASH_THRESHOLD^2 / 4).
    np.testing.assert_allclose(
        _np(ta.attend(_t(q), _t(k), _t(v), causal=causal, window=window,
                      cap=cap)),
        np.asarray(ja.attend(q, k, v, causal=causal, window=window,
                             cap=cap)), rtol=1e-5, atol=1e-5)


def test_decode_attend_across_ring_wrap():
    """A ring of T = 5 slots fed 12 tokens: the cache wraps twice; every
    step's output, the cache and its length equal the reference's
    (rtol/atol 1e-6), with and without a window of 3."""
    rng = np.random.default_rng(3)
    for window in (None, 3):
        jc = ja.KVCache(jnp.zeros((2, 5, 2, 8)), jnp.zeros((2, 5, 2, 8)),
                        jnp.zeros((), jnp.int32))
        tc = ta.KVCache(torch.zeros((2, 5, 2, 8)), torch.zeros((2, 5, 2, 8)),
                        torch.zeros((), dtype=torch.int32))
        for _ in range(12):
            q = rng.standard_normal((2, 1, 4, 8)).astype(np.float32)
            kn, vn = (rng.standard_normal((2, 1, 2, 8)).astype(np.float32)
                      for _ in range(2))
            jo, jc = ja.decode_attend(q, jc, kn, vn, window=window, cap=50.0)
            to, tc = ta.decode_attend(_t(q), tc, _t(kn), _t(vn),
                                      window=window, cap=50.0)
            np.testing.assert_allclose(_np(to), np.asarray(jo),
                                       rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(_np(tc.k), np.asarray(jc.k))
        assert int(tc.length) == int(jc.length) == 12
        assert tc.length.dtype == torch.int32


def test_projection_shapes_match_reference():
    """The planner's attention inventory lives in the attention module,
    as in the reference; it lists the same shapes for every config."""
    for arch in ARCHS:
        assert ta.projection_shapes(get_config(arch)) == \
            ja.projection_shapes(jax_config(arch))


# ----------------------------------------------------------- per arch ----
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_forward_and_loss_match_reference(arch):
    """tests/test_models.py:28 on both packages: the same logits (shape
    and values, LOGITS_TOL) and the same loss (rtol 1e-5)."""
    jm, jp, tm, tp = _pair(arch, 0)
    cfg = jm.cfg
    batch = _batch(cfg)
    want, _ = jm.forward(jp, jnp.asarray(batch["tokens"]),
                         **_extra(cfg, batch, jnp.asarray))
    got, _ = tm.forward(tp, _t(batch["tokens"]), **_extra(cfg, batch, _t))
    exp_s = batch["tokens"].shape[1] + (cfg.n_patches
                                        if cfg.family == "vlm" else 0)
    assert got.shape == (2, exp_s, cfg.vocab_size)
    np.testing.assert_allclose(_np(got), np.asarray(want), **LOGITS_TOL)
    want_loss = float(jm.loss(jp, jax.tree.map(jnp.asarray, batch)))
    got_loss = float(tm.loss(tp, {k: _t(v) for k, v in batch.items()}))
    assert got_loss > 0
    np.testing.assert_allclose(got_loss, want_loss, rtol=1e-5)


@pytest.mark.parametrize("arch", ["gemma2-9b", "qwen3-8b",
                                  "recurrentgemma-9b", "rwkv6-7b",
                                  "deepseek-moe-16b"])
def test_prefill_decode_consistency_matches_reference(arch):
    """tests/test_models.py:64: token-by-token decode reproduces the
    port's own full-sequence forward (rtol/atol 2e-3, the reference
    test's), and every step's logits equal the reference's decode_step
    on the same carried states (LOGITS_TOL)."""
    jm, jp, tm, tp = _pair(arch, 2)
    b, s = 1, 12
    toks = np.random.default_rng(3).integers(3, jm.cfg.vocab_size, (b, s))
    full, _ = tm.forward(tp, _t(toks))
    jst = jm.init_decode_state(b, 32)
    tst = decode_state_from_numpy(jax.tree.map(np.asarray, jst))
    for t in range(s):
        jlog, jst = jm.decode_step(jp, jnp.asarray(toks[:, t:t + 1]),
                                   jnp.full((b, 1), t, jnp.int32), jst)
        tlog, tst = tm.decode_step(tp, _t(toks[:, t:t + 1]),
                                   torch.full((b, 1), t, dtype=torch.int32),
                                   tst)
        np.testing.assert_allclose(_np(tlog[:, 0]), _np(full[:, t]),
                                   rtol=2e-3, atol=2e-3)
        np.testing.assert_allclose(_np(tlog), np.asarray(jlog),
                                   **LOGITS_TOL)


def test_windowed_cache_ring_buffer_matches_reference():
    """tests/test_models.py:85: decode 20 tokens past a window of 8 (the
    local layers' ring wraps); the last logits equal the full forward's
    (2e-3, the reference test's) and the reference's decode
    (LOGITS_TOL)."""
    jcfg = jax_config("gemma2-9b", smoke=True).scaled(window=8)
    jm = jax_build(jcfg)
    jp = jm.init(jax.random.PRNGKey(4))
    tm = build_model(get_config("gemma2-9b", smoke=True).scaled(window=8),
                     engine=CPU)
    tp = _carry(jp)
    b, s = 1, 20
    toks = np.random.default_rng(5).integers(3, jcfg.vocab_size, (b, s))
    full, _ = tm.forward(tp, _t(toks))
    jst = jm.init_decode_state(b, 64)
    tst = tm.init_decode_state(b, 64)
    assert tst["prefix"][0]["self"]["k"].shape[1] == 8  # local: window
    for t in range(s):
        jlog, jst = jm.decode_step(jp, jnp.asarray(toks[:, t:t + 1]),
                                   jnp.full((b, 1), t, jnp.int32), jst)
        tlog, tst = tm.decode_step(tp, _t(toks[:, t:t + 1]),
                                   torch.full((b, 1), t, dtype=torch.int32),
                                   tst)
    np.testing.assert_allclose(_np(tlog[:, 0]), _np(full[:, -1]),
                               rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(_np(tlog), np.asarray(jlog), **LOGITS_TOL)


def test_whisper_cross_attention_matches_reference():
    """tests/test_models.py:106: the encoder output moves the logits, the
    encoder and one decode step over its output equal the reference's
    (rtol/atol 1e-5)."""
    jm, jp, tm, tp = _pair("whisper-small", 6)
    cfg = jm.cfg
    frames = np.random.default_rng(7).standard_normal(
        (1, cfg.enc_frames, cfg.d_model)).astype(np.float32)
    toks = np.asarray([[5, 6, 7, 8]])
    with_enc, _ = tm.forward(tp, _t(toks), enc_frames=_t(frames))
    without, _ = tm.forward(tp, _t(toks), enc_frames=_t(frames * 0))
    assert float((with_enc - without).abs().max()) > 1e-6
    enc = encode(tm.cfg, tp, _t(frames), engine=CPU)
    np.testing.assert_allclose(_np(enc),
                               np.asarray(jax_encode(cfg, jp, frames)),
                               rtol=1e-5, atol=1e-5)
    jst = jm.init_decode_state(1, 16)
    jst["enc_out"] = jax_encode(cfg, jp, frames)
    tst = tm.init_decode_state(1, 16)
    tst["enc_out"] = enc
    jlog, _ = jm.decode_step(jp, jnp.asarray(toks[:, :1]),
                             jnp.zeros((1, 1), jnp.int32), jst)
    tlog, _ = tm.decode_step(tp, _t(toks[:, :1]),
                             torch.zeros((1, 1), dtype=torch.int32), tst)
    assert bool(torch.isfinite(tlog).all())
    np.testing.assert_allclose(_np(tlog), np.asarray(jlog),
                               rtol=1e-5, atol=1e-5)


def test_stack_plan_matches_reference_for_every_config():
    """tests/test_models.py:125 for the three it names, and the port's
    verbatim copy equal to the reference's for every full config."""
    assert stack_plan(get_config("gemma2-9b")) == ((), ("l", "g"), 21, ())
    assert stack_plan(get_config("recurrentgemma-9b")) == \
        ((), ("r", "r", "l"), 12, ("r", "r"))
    assert stack_plan(get_config("deepseek-moe-16b")) == \
        (("d",), ("m",), 27, ())
    for arch in ARCHS:
        assert stack_plan(get_config(arch)) == \
            jax_stack_plan(jax_config(arch)), arch


def test_moe_routing_mass_conservation_matches_reference():
    """tests/test_models.py:133 on the port, and moe_ffn equal to the
    reference's on the same block parameters (rtol/atol 1e-5: the
    scatter-add sums the top-2 experts in another order)."""
    cfg = jax_config("phi3.5-moe-42b-a6.6b", smoke=True)
    p = jb.init_moe_block(cfg, jl.Initializer(jax.random.PRNGKey(0)))
    x = np.random.default_rng(1).standard_normal(
        (4, 16, cfg.d_model)).astype(np.float32)
    y = tb.moe_ffn(get_config("phi3.5-moe-42b-a6.6b", smoke=True),
                   _carry(p), _t(x), engine=CPU)
    assert y.shape == x.shape and bool(torch.isfinite(y).all())
    assert float(torch.linalg.norm(y)) > 0
    np.testing.assert_allclose(_np(y), np.asarray(jb.moe_ffn(cfg, p, x)),
                               rtol=1e-5, atol=1e-5)


def test_init_params_keeps_the_reference_tree():
    """The port's own init draws a tree of the reference's layout: the
    same keys, nesting and shapes (stacked units along axis 0)."""
    for arch in ("gemma2-9b", "whisper-small", "pixtral-12b",
                 "deepseek-moe-16b"):
        jp = jax.eval_shape(jax_build(jax_config(arch, smoke=True)).init,
                            jax.random.PRNGKey(0))
        tp = build_model(get_config(arch, smoke=True), engine=CPU).init(0)
        shapes = jax.tree.map(lambda a: tuple(a.shape), jp)
        assert tree_map(lambda t: tuple(t.shape), tp) == shapes, arch


def test_make_prefill_and_serve_step_pick_greedy_tokens():
    """make_prefill's token is forward's argmax at the last position, and
    make_serve_step's is decode_step's (jit_for returns the step); the
    stacked caches of the two scanned layers advance in place."""
    tm = build_model(get_config("qwen3-8b", smoke=True), engine=CPU)
    tp = tm.init(3)
    toks = _t(np.random.default_rng(0).integers(3, 256, (2, 5)))
    prefill, jit_pre = make_prefill(tm)
    assert jit_pre(tp, {"tokens": toks}) is prefill
    logits, _ = tm.forward(tp, toks)
    nxt = prefill(tp, {"tokens": toks})
    assert nxt.dtype == torch.int32 and nxt.shape == (2, 1)
    assert torch.equal(nxt[:, 0], logits[:, -1].argmax(-1).to(torch.int32))
    serve, jit_for = make_serve_step(tm)
    st = tm.init_decode_state(2, 8)
    pos = torch.zeros((2, 1), dtype=torch.int32)
    assert jit_for(tp, st, {"token": nxt, "position": pos}) is serve
    lengths = st["scan"][0]["self"]["length"]
    tok, st2 = serve(tp, st, nxt, pos)
    logits, _ = tm.decode_step(tp, nxt, pos, tm.init_decode_state(2, 8))
    assert torch.equal(tok[:, 0], logits[:, -1].argmax(-1).to(torch.int32))
    assert st2["scan"][0]["self"]["length"] is lengths
    assert lengths.tolist() == [1, 1]


def test_model_lives_on_its_engine_device():
    """build_model takes the engine's device; a device that is not the
    engine's is refused, and the default engine needs CUDA."""
    tm = build_model(get_config("qwen3-8b", smoke=True), engine=CPU)
    assert tm.device == torch.device("cpu") and tm.engine is CPU
    assert tm.init(0)["embed"].device.type == "cpu"
    with pytest.raises(ValueError, match="engine's device"):
        build_model(get_config("qwen3-8b", smoke=True), engine=CPU,
                    device="meta")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            build_model(get_config("qwen3-8b", smoke=True))
