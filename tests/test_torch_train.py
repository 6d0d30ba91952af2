"""repro_torch's training path against the JAX package's, on the CPU: the
tree order, each smoke architecture's gradients leaf by leaf (with and
without remat) and a PIM-aware (``fake``) model's gradients
(``tests/test_torch_train_step.py`` holds the composed step).

Tolerances, with their reasons. Both packages compute in float32 in
different summation orders: losses agree to about 1e-7 relative and
each gradient leaf to about 1e-6 of its norm (rwkv6's worst leaf 1.7e-6
in a probe), so a leaf is held within a relative norm of 1e-5 and a loss
within rtol 1e-5. Rematerialisation recomputes the same operations on
the same inputs, so its gradients are equal bit for bit.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import ARCHS, get_config as jax_config  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro.optim import adamw as ja  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.engine import Engine  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.optim import OptState, adamw_init  # noqa: E402
from repro_torch.tree import (keystr, tree_flatten,  # noqa: E402
                              tree_flatten_with_path, tree_leaves,
                              tree_map, tree_unflatten)

pytestmark = pytest.mark.infra

CPU = Engine("torch:device=cpu")
LEAF_REL = 1e-5
LOSS_RTOL = 1e-5


def _batch(cfg, b=2, s=16, seed=0):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(3, cfg.vocab_size, (b, s),
                                    dtype=np.int32),
             "labels": rng.integers(3, cfg.vocab_size, (b, s),
                                    dtype=np.int32)}
    if cfg.family == "vlm":
        batch["patches"] = rng.standard_normal(
            (b, cfg.n_patches, cfg.d_model)).astype(np.float32)
    if cfg.family == "encdec":
        batch["frames"] = rng.standard_normal(
            (b, cfg.enc_frames, cfg.d_model)).astype(np.float32)
    return batch


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _carry(jax_params):
    """The reference's parameters as the port's, each a leaf to train."""
    params = params_from_numpy(jax.tree.map(np.asarray, jax_params))
    tree_map(lambda x: x.requires_grad_(), params)
    return params


def _rel(a, b) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


# ----------------------------------------------------------------- trees ----
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_tree_order_is_jax_order(arch):
    """The port's own parameter tree (its init, in its insertion order)
    and its OptState flatten to the key paths, in the order,
    ``jax.tree_util.tree_flatten_with_path`` gives for the reference's;
    unflatten rebuilds the same tree."""
    jm = jax_build(jax_config(arch, smoke=True))
    jp = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    params = build_model(get_config(arch, smoke=True), engine=CPU).init(0)
    for jtree, ttree in ((jp, params),
                         (jax.eval_shape(ja.adamw_init, jp),
                          adamw_init(params))):
        want = [(jax.tree_util.keystr(k), tuple(v.shape))
                for k, v in jax.tree_util.tree_flatten_with_path(jtree)[0]]
        pairs, treedef = tree_flatten_with_path(ttree)
        assert [(keystr(k), tuple(v.shape)) for k, v in pairs] == want
        back = tree_unflatten(treedef, [v for _, v in pairs])
        assert all(a is b for a, b in zip(tree_leaves(back),
                                          tree_leaves(ttree)))


def test_tree_map_rebuilds_namedtuples_and_keeps_none():
    """tree_map rebuilds a NamedTuple (OptState) as its type, keeps a
    dict's own key order, and leaves None an empty subtree."""
    st = OptState(m={"b": torch.ones(2), "a": torch.zeros(1)},
                  v=[None, torch.ones(3)], count=torch.tensor(0))
    out = tree_map(lambda x: x + 1, st)
    assert isinstance(out, OptState) and list(out.m) == ["b", "a"]
    assert out.v[0] is None and torch.equal(out.v[1], torch.full((3,), 2.))
    leaves, treedef = tree_flatten(st)
    assert [tuple(x.shape) for x in leaves] == [(1,), (2,), (3,), ()]
    assert treedef.num_leaves == 4


@pytest.mark.parametrize("walk", ["flatten", "map"])
def test_tree_walks_leave_no_reference_cycle(walk):
    """A leaf that a walk saw is freed as soon as the caller drops it,
    with the garbage collector off: the walks hold no reference cycle
    (which would keep a train step's gradients alive into the next)."""
    import gc
    import weakref
    x = torch.ones(4)
    seen = weakref.ref(x)
    tree = {"a": [x, None], "b": (torch.zeros(1),)}
    was = gc.isenabled()
    gc.disable()
    try:
        if walk == "flatten":
            leaves, _ = tree_flatten(tree)
            del leaves
        else:
            tree_map(lambda t, held=x: t, tree)   # fn holds x
        del tree, x
        assert seen() is None
    finally:
        if was:
            gc.enable()


# ------------------------------------------------------------- gradients ----
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_gradients_match_reference(arch):
    """Loss and every gradient leaf, matched by key path, against
    ``jax.value_and_grad(model.loss)`` on the same parameters and batch;
    no leaf unused; with remat the gradients are equal bit for bit."""
    jcfg = jax_config(arch, smoke=True)
    jm = jax_build(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    batch = _batch(jcfg)
    jl, jg = jax.jit(jax.value_and_grad(jm.loss))(
        jp, jax.tree.map(jnp.asarray, batch))
    params = _carry(jp)
    paths = [keystr(k) for k, _ in tree_flatten_with_path(params)[0]]
    grads = {}
    for remat in (False, True):
        m = build_model(get_config(arch, smoke=True), remat=remat,
                        engine=CPU)
        loss = m.loss(params, _torch_batch(batch))
        grads[remat] = torch.autograd.grad(loss, tree_leaves(params))
        np.testing.assert_allclose(float(loss.detach()), float(jl),
                                   rtol=LOSS_RTOL)
    want = jax.tree_util.tree_flatten_with_path(jg)[0]
    assert paths == [jax.tree_util.keystr(k) for k, _ in want]
    for path, (_, w), g in zip(paths, want, grads[False]):
        assert _rel(g.numpy(), w) <= LEAF_REL, path
    for g, gr in zip(grads[False], grads[True]):
        assert torch.equal(g, gr)


def test_fake_pim_gradients_match_reference():
    """gemma2-9b smoke with every block projection and the head in
    ``pim_linear_mode="fake"`` (quantize-dequantize, the reference's
    PIM-aware finetuning mode): the quantizer's round passes no
    gradient, so the projections learn through their scales' amax;
    loss and every leaf against the reference within the same
    tolerances."""
    over = dict(pim_linear_mode="fake", pim_block_mode="full")
    jcfg = dataclasses.replace(jax_config("gemma2-9b", smoke=True), **over)
    jm = jax_build(jcfg)
    jp = jm.init(jax.random.PRNGKey(1))
    batch = _batch(jcfg, seed=1)
    jl, jg = jax.jit(jax.value_and_grad(jm.loss))(
        jp, jax.tree.map(jnp.asarray, batch))
    cfg = dataclasses.replace(get_config("gemma2-9b", smoke=True), **over)
    params = _carry(jp)
    loss = build_model(cfg, engine=CPU).loss(params, _torch_batch(batch))
    grads = torch.autograd.grad(loss, tree_leaves(params))
    np.testing.assert_allclose(float(loss.detach()), float(jl),
                               rtol=LOSS_RTOL)
    for g, w in zip(grads, jax.tree.leaves(jg)):
        assert _rel(g.numpy(), w) <= LEAF_REL
