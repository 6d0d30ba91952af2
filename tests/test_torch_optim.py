"""repro_torch.optim against the JAX package's repro.optim, on the CPU:
AdamW on identical grads, moments and parameters (rtol 1e-6: the same
float32 operations, one multiply-add fused where the reference rounds
twice), the schedule, the global norm and clipping, and the int8
error-feedback compression bit for bit (float32 divide, round half to
even, clamp and multiply, correctly rounded in both packages)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.optim import adamw as ja  # noqa: E402
from repro.optim import compress as jc  # noqa: E402
from repro_torch.optim import adamw as ta  # noqa: E402
from repro_torch.optim import compress as tc  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

pytestmark = pytest.mark.infra

SHAPES = {"embed": (16, 8), "final_norm": (8,),
          "scan": [{"wq": (3, 8, 8), "ln1": (3, 8)}], "lam": (5,)}


def _tree(rng, scale=1.0):
    def leaf(shape):
        return (rng.standard_normal(shape) * scale).astype(np.float32)
    return {"embed": leaf(SHAPES["embed"]),
            "final_norm": leaf(SHAPES["final_norm"]),
            "scan": [{k: leaf(s) for k, s in SHAPES["scan"][0].items()}],
            "lam": leaf(SHAPES["lam"])}


def _torch_tree(t):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), t)


def _jax_tree(t):
    return jax.tree.map(jnp.asarray, t)


def _leaves_np(tree):
    return [np.asarray(x.detach().numpy() if isinstance(x, torch.Tensor)
                       else x) for x in tree_leaves(tree)]


@pytest.mark.parametrize("clip_norm,weight_decay", [(1.0, 0.1),
                                                    (100.0, 0.0)])
def test_adamw_update_matches_reference(clip_norm, weight_decay):
    """Five steps on the same grads, from the same parameters: every
    parameter and moment within rtol 1e-6, lr and grad_norm too, count
    advanced; clipping active in the first case (norms ~10 against 1)
    and idle in the second. The global norm is a float32 sum in another
    order, so the clip scale may differ in its last bit; an element that
    is a sum which cancels (``b1 m + (1 - b1) g``, ``p - lr step``)
    carries that error at the scale of its terms, so atol is 1e-6 of the
    leaf's largest magnitude."""
    rng = np.random.default_rng(0)
    p0 = _tree(rng)
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=10, clip_norm=clip_norm,
              weight_decay=weight_decay)
    jp, tp = _jax_tree(p0), _torch_tree(p0)
    js, ts = ja.adamw_init(jp), ta.adamw_init(tp)
    for i in range(5):
        g = _tree(rng, scale=float(i + 1))
        jp, js, jm = ja.adamw_update(ja.AdamWConfig(**kw), _jax_tree(g), js,
                                     jp)
        tp2, ts, tm = ta.adamw_update(ta.AdamWConfig(**kw), _torch_tree(g),
                                      ts, tp)
        assert tp2 is tp                       # updated in place
        for name in ("lr", "grad_norm"):
            np.testing.assert_allclose(float(tm[name]), float(jm[name]),
                                       rtol=1e-6)
        assert int(ts.count) == int(js.count) == i + 1
        assert ts.count.dtype == torch.int32 and ts.count.ndim == 0
        for want, got in zip(jax.tree.leaves((jp, js.m, js.v)),
                             _leaves_np((tp, ts.m, ts.v))):
            want = np.asarray(want)
            np.testing.assert_allclose(
                got, want, rtol=1e-6, atol=1e-6 * np.abs(want).max())


def test_adamw_decays_matrices_only():
    """With zero gradients, a matrix shrinks by lr * wd * p and a vector
    does not move."""
    cfg = ta.AdamWConfig(lr=0.1, warmup_steps=0, total_steps=10,
                         weight_decay=0.5)
    p = {"w": torch.ones(2, 2), "b": torch.ones(2)}
    g = {"w": torch.zeros(2, 2), "b": torch.zeros(2)}
    p, s, m = ta.adamw_update(cfg, g, ta.adamw_init(p), p)
    lr = float(m["lr"])
    torch.testing.assert_close(p["w"], torch.full((2, 2), 1 - lr * 0.5))
    assert torch.equal(p["b"], torch.ones(2))


def test_cosine_schedule_matches_reference():
    """Every step of warmup and decay, and past the end: rtol 1e-6."""
    for kw in (dict(lr=3e-4, warmup_steps=10, total_steps=100),
               dict(lr=1.0, warmup_steps=0, total_steps=7,
                    min_lr_ratio=0.0)):
        jf = ja.cosine_schedule(ja.AdamWConfig(**kw))
        tf = ta.cosine_schedule(ta.AdamWConfig(**kw))
        for step in range(kw["total_steps"] + 5):
            got = tf(torch.tensor(step, dtype=torch.int32))
            assert got.dtype == torch.float32
            np.testing.assert_allclose(float(got),
                                       float(jf(jnp.asarray(step))),
                                       rtol=1e-6, atol=1e-12)


def test_global_norm_and_clipping_match_reference():
    """The global norm (float32 sums in another order: rtol 1e-6), the
    clipped tree, and no clipping below the limit."""
    rng = np.random.default_rng(1)
    t = _tree(rng, scale=3.0)
    jn = ja.global_norm(_jax_tree(t))
    tn = ta.global_norm(_torch_tree(t))
    np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
    for max_norm in (1.0, 1e4):
        jt, jn2 = ja.clip_by_global_norm(_jax_tree(t), max_norm)
        tt, tn2 = ta.clip_by_global_norm(_torch_tree(t), max_norm)
        np.testing.assert_allclose(float(tn2), float(jn2), rtol=1e-6)
        for want, got in zip(jax.tree.leaves(jt), _leaves_np(tt)):
            np.testing.assert_allclose(got, np.asarray(want), rtol=1e-6)
    _, norm = ta.clip_by_global_norm(_torch_tree(t), 1e4)
    assert float(norm) < 1e4


@pytest.mark.parametrize("scale", [1e-3, 1.0, 1e3])
def test_quantize_grad_bit_exact(scale):
    """int8 values, the float32 scale and the dequantized values equal
    the reference's bit for bit."""
    rng = np.random.default_rng(2)
    g = (rng.standard_normal(4096) * scale).astype(np.float32)
    g[0] = 0.0
    jq, js = jc.quantize_grad(jnp.asarray(g))
    tq, ts = tc.quantize_grad(torch.from_numpy(g))
    assert tq.dtype == torch.int8
    assert np.array_equal(tq.numpy(), np.asarray(jq))
    assert ts.numpy().tobytes() == np.asarray(js).tobytes()
    assert (tc.dequantize_grad(tq, ts).numpy().tobytes()
            == np.asarray(jc.dequantize_grad(jq, js)).tobytes())


def test_ef_compress_tree_bit_exact():
    """Ten steps of error feedback over a tree: applied grads and the
    residual equal the reference's bit for bit at every step."""
    rng = np.random.default_rng(3)
    t0 = _tree(rng)
    jr = jax.tree.map(jnp.zeros_like, _jax_tree(t0))
    tr = jax.tree.map(torch.zeros_like, _torch_tree(t0))
    for _ in range(10):
        g = _tree(rng, scale=1e-3)
        jd, jr = jc.ef_compress_tree(_jax_tree(g), jr)
        td, tr = tc.ef_compress_tree(_torch_tree(g), tr)
        for want, got in zip(jax.tree.leaves((jd, jr)), _leaves_np((td, tr))):
            assert got.tobytes() == np.asarray(want).tobytes()


def test_compressed_psum_world_size_one(tmp_path):
    """On a one-process gloo group (a FileStore, no network) the
    all-reduced mean equals the reference's ``compressed_psum`` over a
    one-wide vmapped axis, bit for bit."""
    import torch.distributed as dist
    rng = np.random.default_rng(4)
    g = rng.standard_normal((64, 32)).astype(np.float32)
    want = jax.vmap(lambda x: jc.compressed_psum(x, "i"),
                    axis_name="i")(jnp.asarray(g)[None])[0]
    store = dist.FileStore(str(tmp_path / "store"), 1)
    dist.init_process_group("gloo", store=store, rank=0, world_size=1)
    try:
        got = tc.compressed_psum(torch.from_numpy(g))
    finally:
        dist.destroy_process_group()
    assert got.dtype == torch.float32
    assert got.numpy().tobytes() == np.asarray(want).tobytes()
