"""repro_torch's composed train step against the JAX package's, on the
CPU: three steps of ``make_train_step`` (one microbatch; two with remat;
int8 error feedback) against the reference's unjitted ``train_step`` or,
at two microbatches, its hand-built composition.

Tolerances, with their reasons: losses and grad norms are float32 sums
in other orders (rtol 1e-5, as ``tests/test_torch_train.py``). After a
step, AdamW moves each parameter by about ``sign(g) * lr`` (at count 1,
``m / sqrt(v) = g / |g|``), so where a gradient is at the level of float
noise the two packages may move it in opposite directions: parameters
are compared in norm (relative 1e-4), never elementwise.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as jax_config  # noqa: E402
from repro.data import DataConfig, make_batch_fn  # noqa: E402
from repro.launch.mesh import make_host_mesh  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro.optim import adamw as ja  # noqa: E402
from repro.train import make_train_step as jax_train_step  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.engine import Engine  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.optim import AdamWConfig, adamw_init  # noqa: E402
from repro_torch.train import make_train_step  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402

pytestmark = pytest.mark.infra

CPU = Engine("torch:device=cpu")
LOSS_RTOL = 1e-5
PARAM_REL = 1e-4


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


# ---------------------------------------------------------- composed step ----
def _jax_composed_step(jm, opt_cfg, microbatches):
    """The reference's microbatched step built by hand: its jitted step
    needs mesh axes this host cannot constrain, so ``value_and_grad``
    over each split, the float32 sums scaled by 1/microbatches, then
    ``adamw_update`` (``repro/train/step.py:43-85``)."""
    def step(params, opt, resid, batch):
        total, acc = 0.0, None
        size = batch["tokens"].shape[0] // microbatches
        for i in range(microbatches):
            one = {k: v[i * size:(i + 1) * size] for k, v in batch.items()}
            l, g = jax.value_and_grad(jm.loss)(params, one)
            total = total + l
            acc = g if acc is None else jax.tree.map(jnp.add, acc, g)
        inv = 1.0 / microbatches
        params, opt, met = ja.adamw_update(
            opt_cfg, jax.tree.map(lambda g: g * inv, acc), opt, params)
        met["loss"] = total * inv
        return params, opt, resid, met
    return step


@pytest.mark.parametrize("arch,microbatches,remat,compress", [
    ("qwen3-8b", 1, False, False),
    ("qwen3-8b", 2, True, False),
    ("deepseek-7b", 1, False, True),
])
def test_train_step_matches_reference(arch, microbatches, remat, compress):
    """Three steps of the port's ``make_train_step`` against the
    reference's unjitted ``train_step`` (one microbatch) or the
    hand-built composition (two), from the same parameters on the same
    stream: loss, grad_norm and lr each step, the parameters in norm
    after the last."""
    kw = dict(lr=3e-3, warmup_steps=2, total_steps=60)
    jcfg = jax_config(arch, smoke=True)
    jm = jax_build(jcfg, remat=remat)
    jstep, jinit, _ = jax_train_step(jm, ja.AdamWConfig(**kw),
                                     make_host_mesh(),
                                     compress_grads=compress)
    jp, jo, jr = jinit(jax.random.PRNGKey(0))
    if microbatches > 1:
        jstep = _jax_composed_step(jm, ja.AdamWConfig(**kw), microbatches)
    m = build_model(get_config(arch, smoke=True), remat=remat, engine=CPU)
    step, _, jit_for = make_train_step(
        m, AdamWConfig(**kw), microbatches=microbatches,
        compress_grads=compress)
    params = _carry(jp)
    opt = adamw_init(params)
    resid = tree_map(torch.zeros_like, params) if compress else None
    step = jit_for(params, None)
    stream = make_batch_fn(DataConfig(vocab_size=jcfg.vocab_size, seq_len=32,
                                      global_batch=8))
    for s in range(3):
        b = stream(s)
        jp, jo, jr, jmet = jstep(jp, jo, jr, jax.tree.map(jnp.asarray, b))
        params, opt, resid, met = step(params, opt, resid, _torch_batch(b))
        np.testing.assert_allclose(float(met["loss"]), float(jmet["loss"]),
                                   rtol=LOSS_RTOL)
        np.testing.assert_allclose(float(met["grad_norm"]),
                                   float(jmet["grad_norm"]), rtol=LOSS_RTOL)
        np.testing.assert_allclose(float(met["lr"]), float(jmet["lr"]),
                                   rtol=1e-6)
    assert int(opt.count) == 3
    want = np.concatenate([np.ravel(x) for x in jax.tree.leaves(jp)])
    got = np.concatenate([x.detach().numpy().ravel()
                          for x in tree_leaves(params)])
    assert _rel(got, want) <= PARAM_REL


def test_train_step_init_and_microbatch_guard():
    """init_fn gives trainable leaves, zero state and (under
    compression) a zero residual; a batch that does not split raises."""
    m = build_model(get_config("qwen3-8b", smoke=True), engine=CPU)
    step, init_fn, _ = make_train_step(m, AdamWConfig(), microbatches=3,
                                       compress_grads=True)
    params, opt, resid = init_fn(0)
    assert all(x.requires_grad for x in tree_leaves(params))
    assert int(opt.count) == 0 and not any(
        x.requires_grad or bool(x.any()) for x in tree_leaves(opt.m))
    assert all(not bool(x.any()) for x in tree_leaves(resid))
    rng = np.random.default_rng(0)
    b = {k: torch.from_numpy(rng.integers(3, 256, (4, 8))) for k in
         ("tokens", "labels")}
    with pytest.raises(ValueError, match="microbatches"):
        step(params, opt, resid, b)
