"""repro_torch's training infrastructure, on the CPU: the ports of
``tests/test_train_infra.py`` (optimizer, checkpointing, fault
tolerance, compression, data pipeline, sharding rules) and of
``tests/test_faults.py``'s two training tests, plus the port held
against the JAX package: the partition specs of every leaf of the ten
full configurations on 16 x 16 and 2 x 16 x 16 meshes, checkpoints
restored across packages in both directions, and the data pipeline's
batches byte for byte."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: E402

from repro.configs import ARCHS, get_config as jax_config  # noqa: E402
from repro.data import DataConfig as JaxDataConfig  # noqa: E402
from repro.data import SyntheticStream as JaxStream  # noqa: E402
from repro.data import make_batch_fn as jax_batch_fn  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro.optim import adamw as ja  # noqa: E402
from repro.train import checkpoint as jckpt  # noqa: E402
from repro.train import sharding as jsh  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.data import (DataConfig, SyntheticStream,  # noqa: E402
                              make_batch_fn)
from repro_torch.faults.policy import RetryPolicy  # noqa: E402
from repro_torch.launch.mesh import Mesh, make_host_mesh  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.transformer import (init_decode_state,  # noqa: E402
                                            init_params)
from repro_torch.optim.adamw import (AdamWConfig, adamw_init,  # noqa: E402
                                     adamw_update, cosine_schedule)
from repro_torch.optim.compress import (ef_compress_tree,  # noqa: E402
                                        quantize_grad)
from repro_torch.train import sharding as tsh  # noqa: E402
from repro_torch.train.checkpoint import (latest_step,  # noqa: E402
                                          restore_checkpoint,
                                          save_checkpoint)
from repro_torch.train.fault import (RetryingRunner,  # noqa: E402
                                     StragglerWatch, choose_mesh_shape,
                                     elastic_remesh)
from repro_torch.tree import keystr, tree_flatten_with_path, tree_leaves  # noqa: E402,E501

pytestmark = pytest.mark.infra


def _counters():
    return dict(obs.dump()["counters"])


def _delta(before, name):
    return _counters().get(name, 0) - before.get(name, 0)


# ------------------------------------------ ports of test_train_infra.py ----
def test_adamw_converges_quadratic():
    cfg = AdamWConfig(lr=0.1, warmup_steps=0, total_steps=200,
                      weight_decay=0.0, clip_norm=10.0)
    params = {"w": torch.tensor([5.0, -3.0])}
    opt = adamw_init(params)
    for _ in range(150):
        g = {"w": 2 * params["w"]}          # d/dw ||w||^2
        params, opt, _ = adamw_update(cfg, g, opt, params)
    assert float(torch.max(torch.abs(params["w"]))) < 0.2


def test_cosine_schedule_shape():
    cfg = AdamWConfig(lr=1.0, warmup_steps=10, total_steps=100,
                      min_lr_ratio=0.1)
    lr = cosine_schedule(cfg)
    assert float(lr(torch.tensor(0))) == 0.0
    assert float(lr(torch.tensor(10))) == pytest.approx(1.0)
    assert float(lr(torch.tensor(100))) == pytest.approx(0.1, abs=1e-3)


def test_checkpoint_roundtrip(tmp_path):
    tree = {"a": torch.arange(6).reshape(2, 3).to(torch.float32),
            "b": [torch.ones(4), torch.zeros(2)]}
    save_checkpoint(str(tmp_path), 7, tree)
    got, step = restore_checkpoint(str(tmp_path), tree)
    assert step == 7
    for x, y in zip(tree_leaves(tree), tree_leaves(got)):
        assert torch.equal(x, y) and x.dtype == y.dtype


def test_checkpoint_atomic_publish_and_retention(tmp_path):
    tree = {"w": torch.ones(3)}
    for s in (1, 2, 3, 4, 5):
        save_checkpoint(str(tmp_path), s, tree)
    names = sorted(os.listdir(tmp_path))
    assert names == ["step_000000003", "step_000000004", "step_000000005"]
    assert latest_step(str(tmp_path)) == 5


def test_checkpoint_corruption_detected(tmp_path):
    tree = {"w": torch.ones(8)}
    path = save_checkpoint(str(tmp_path), 1, tree)
    npz = os.path.join(path, "proc00.npz")
    data = dict(np.load(npz))
    data["leaf0"] = data["leaf0"] + 1.0
    np.savez(npz, **data)
    with pytest.raises(IOError, match="corruption"):
        restore_checkpoint(str(tmp_path), tree)


def test_retrying_runner_recovers(tmp_path):
    """Inject a failure mid-run; the runner restores and completes with
    a bit-identical final state (deterministic data)."""
    cfg = AdamWConfig(lr=0.05, warmup_steps=0, total_steps=100)

    def step_fn(params, opt, resid, batch):
        loss = torch.sum((params["w"] - batch) ** 2)
        g, = torch.autograd.grad(loss, [params["w"]])
        params, opt, m = adamw_update(cfg, {"w": g}, opt, params)
        m["loss"] = loss.detach()
        return params, opt, resid, m

    def batch_fn(step):
        return torch.tensor(float(np.sin(step)))

    def fresh():
        p = {"w": torch.tensor(1.0, requires_grad=True)}
        return p, adamw_init(p), None

    params, opt, resid = fresh()
    save_checkpoint(str(tmp_path), 0, {"params": params, "opt": opt})
    runner = RetryingRunner(step_fn=step_fn, batch_fn=batch_fn,
                            ckpt_dir=str(tmp_path), ckpt_every=4)
    boom = {"armed": True}

    def inject(step):
        if step == 6 and boom["armed"]:
            boom["armed"] = False
            raise RuntimeError("simulated device loss")

    (p1, o1, _), metrics = runner.run((params, opt, resid), 0, 10,
                                      inject_failure=inject)
    assert metrics["restarts"] == 1

    params, opt, resid = fresh()
    runner2 = RetryingRunner(step_fn=step_fn, batch_fn=batch_fn,
                             ckpt_dir=str(tmp_path / "b"), ckpt_every=4)
    (p2, o2, _), _ = runner2.run((params, opt, resid), 0, 10)
    np.testing.assert_allclose(p1["w"].detach().numpy(),
                               p2["w"].detach().numpy(), rtol=1e-6)


def test_straggler_watch():
    w = StragglerWatch(slow_factor=2.0)
    for _ in range(5):
        assert not w.observe_step(1.0)
    assert w.observe_step(3.0, slowest_host=7)       # straggler
    assert not w.observe_step(1.1)
    assert w.observe_step(2.5, slowest_host=7)
    assert w.observe_step(2.5, slowest_host=7)
    assert w.evict_candidates(strikes=3) == [7]
    w.heartbeat(3, t=0.0)
    assert 3 in w.dead_hosts(now=1000.0)


def test_elastic_mesh_shape():
    assert choose_mesh_shape(256, 16) == (16, 16)
    assert choose_mesh_shape(240, 16) == (15, 16)     # lost a host of 16
    assert choose_mesh_shape(250, 16) == (125, 2)     # odd survivor count
    assert choose_mesh_shape(7, 16) == (7, 1)
    mesh = elastic_remesh([f"d{i}" for i in range(240)], 16)
    assert isinstance(mesh, Mesh) and mesh.shape == {"data": 15, "model": 16}
    assert mesh.devices[1][0] == "d16" and len(mesh.devices) == 15


def test_error_feedback_compression():
    rng = np.random.default_rng(0)
    r = {"w": torch.zeros(1000)}
    total_true = np.zeros(1000)
    total_applied = np.zeros(1000)
    for _ in range(50):
        gg = {"w": torch.from_numpy(rng.standard_normal(1000) * 1e-3)
              .to(torch.float32)}
        total_true += gg["w"].numpy()
        dq, r = ef_compress_tree(gg, r)
        total_applied += dq["w"].numpy()
    # error feedback: accumulated applied ~= accumulated true
    err = np.linalg.norm(total_applied - total_true)
    assert err / np.linalg.norm(total_true) < 0.05


def test_quantize_grad_range():
    g = torch.tensor([-1.0, 0.5, 0.25])
    q, s = quantize_grad(g)
    assert q.dtype == torch.int8
    np.testing.assert_allclose(q.numpy().astype(np.float32) * float(s),
                               g.numpy(), atol=float(s))


def test_data_determinism_and_sharding():
    cfg = DataConfig(vocab_size=1000, seq_len=16, global_batch=8)
    a = SyntheticStream(cfg).batch_at(3)
    b = SyntheticStream(cfg).batch_at(3)
    np.testing.assert_array_equal(a["tokens"], b["tokens"])
    # host-sharded view partitions the global batch
    h0 = SyntheticStream(cfg, 0, 2).batch_at(3)
    h1 = SyntheticStream(cfg, 1, 2).batch_at(3)
    glob = np.concatenate([h0["tokens"], h1["tokens"]])
    np.testing.assert_array_equal(glob, a["tokens"])
    assert (a["labels"][:, :-1] == a["tokens"][:, 1:]).all()


def test_sharding_rules_divisibility_guard():
    mesh = tsh.abstract_mesh((16, 16), ("data", "model"))
    # divisible dims shard; a 3-wide dim can't shard over 16:
    assert tsh.spec_for_leaf(mesh, "wk", (6144, 3)) == (None, None)
    assert tsh.spec_for_leaf(mesh, "wk", (6144, 128)) == (None, "model")
    assert tsh.spec_for_leaf(mesh, "wq", (6144, 6144)) == (None, "model")
    # whisper's 51865 vocab is not divisible by 16 -> replicate
    assert tsh.spec_for_leaf(mesh, "embed", (51865, 768)) == (None, None)
    assert tsh.spec_for_leaf(mesh, "embed", (102400, 4096)) == \
        ("model", None)
    # stacked (leading layer axis) inherits trailing rules
    assert tsh.spec_for_leaf(mesh, "we1", (32, 16, 4096, 6400)) == \
        (None, "model", None, None)
    # ZeRO-1 adds 'data' on the largest free divisible dim
    assert tsh.zero1_spec(mesh, "wq", (30, 4096, 4096)) == \
        (None, "data", "model")


# ------------------------------------------- ports of test_faults.py ----
def test_retrying_runner_delegates_to_shared_policy():
    r = RetryingRunner(step_fn=lambda *a: None, batch_fn=lambda s: None,
                       ckpt_dir="/nonexistent", max_retries=5)
    assert isinstance(r.policy, RetryPolicy)
    assert r.policy.max_retries == 5
    assert r.policy.scope == "train.retry"
    custom = RetryPolicy(max_retries=1, scope="t.train")
    r2 = RetryingRunner(step_fn=lambda *a: None, batch_fn=lambda s: None,
                        ckpt_dir="/nonexistent", policy=custom)
    assert r2.policy is custom


def test_straggler_watch_counts_into_obs():
    w = StragglerWatch(slow_factor=2.0)
    c0 = _counters()
    assert not w.observe_step(1.0)              # seeds the EMA
    assert w.observe_step(10.0, slowest_host=4)
    assert _delta(c0, "train.straggler.events") == 1
    w.heartbeat(0, t=0.0)
    assert w.dead_hosts(now=1000.0) == [0]
    assert obs.dump()["gauges"].get("train.straggler.dead_hosts") == 1


def test_retrying_runner_counts_retries_and_gives_up(tmp_path):
    """Every retry lands on ``train.retry.retries``; past max_retries
    consecutive failures the error propagates and ``exhausted`` counts."""
    def step_fn(*_):
        raise RuntimeError("always")
    r = RetryingRunner(step_fn=step_fn, batch_fn=lambda s: None,
                       ckpt_dir=str(tmp_path), max_retries=2)
    c0 = _counters()
    with pytest.raises(RuntimeError, match="always"):
        r.run(({}, None, None), 0, 3)
    assert _delta(c0, "train.retry.retries") == 2
    assert _delta(c0, "train.retry.exhausted") == 1


# ------------------------------------------------ against the reference ----
@pytest.mark.parametrize("axes", [((16, 16), ("data", "model")),
                                  ((2, 16, 16), ("pod", "data", "model"))],
                         ids=["16x16", "2x16x16"])
def test_full_config_specs_match_reference(axes):
    """Every parameter leaf of the ten full configurations (shapes only:
    the port's init under FakeTensorMode, the reference's under
    eval_shape), spec for spec, param and ZeRO-1; and the decode-state
    and batch specs at batch 32, cache 64, matched by key path."""
    jmesh = jsh.abstract_mesh(*axes)
    tmesh = tsh.abstract_mesh(*axes)

    def ref_specs(tree):
        return [(jax.tree_util.keystr(k), tuple(v.spec)) for k, v in
                jax.tree_util.tree_flatten_with_path(tree)[0]]

    def port_specs(tree):
        return [(keystr(k), v) for k, v in tree_flatten_with_path(
            tree, is_leaf=lambda x: isinstance(x, tuple)
            and not hasattr(x, "_fields"))[0]]

    for arch in sorted(ARCHS):
        jm = jax_build(jax_config(arch))
        jp = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
        js = jax.eval_shape(lambda: jm.init_decode_state(32, 64))
        cfg = get_config(arch)
        with FakeTensorMode():
            tp = init_params(cfg, torch.Generator().manual_seed(0))
            ts = init_decode_state(cfg, 32, 64)
        assert port_specs(tsh.param_shardings(tmesh, tp)) == \
            ref_specs(jsh.param_shardings(jmesh, jp)), arch
        assert port_specs(tsh.zero1_shardings(tmesh, tp)) == \
            ref_specs(jsh.zero1_shardings(jmesh, jp)), arch
        assert port_specs(tsh.state_shardings(tmesh, ts)) == \
            ref_specs(jsh.state_shardings(jmesh, js)), arch
    batch = {"tokens": np.zeros((32, 8)), "patches": np.zeros((3, 4, 8))}
    assert port_specs(tsh.batch_shardings(tmesh, batch)) == \
        ref_specs(jsh.batch_shardings(jmesh, batch))
    assert tsh.logits_sharding(tmesh) == tuple(
        jsh.logits_sharding(jmesh).spec)


def test_host_mesh_is_one_device_here():
    """On a host without a card the mesh is (1, 1) over the CPU; every
    spec on it resolves to replication (axes of size 1)."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the mesh spans its cards")
    mesh = make_host_mesh()
    assert mesh.shape == {"data": 1, "model": 1}
    assert mesh.devices == ((torch.device("cpu"),),)
    with pytest.raises(ValueError, match="model_parallel"):
        make_host_mesh(2)


def _train_trees(seed):
    """The reference's qwen3-8b smoke parameters and AdamW state after
    one update, and the same carried into the port's trees."""
    jm = jax_build(jax_config("qwen3-8b", smoke=True))
    jp = jm.init(jax.random.PRNGKey(seed))
    jo = ja.adamw_init(jp)
    jp, jo, _ = ja.adamw_update(ja.AdamWConfig(), jax.tree.map(
        lambda x: jnp.ones_like(x) * 0.01, jp), jo, jp)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp))
    to = adamw_init(tp)
    for dst, src in zip(tree_leaves(to), jax.tree.leaves(jo)):
        dst.copy_(torch.from_numpy(np.array(src)))
    return {"params": jp, "opt": jo}, {"params": tp, "opt": to}


def test_checkpoint_crosses_packages(tmp_path):
    """A checkpoint the reference writes restores in the port, and one
    the port writes restores in the reference, with equal leaves at
    equal key paths (dtypes kept: count int32)."""
    jtree, ttree = _train_trees(0)
    jckpt.save_checkpoint(str(tmp_path / "j"), 5, jtree)
    like = _train_trees(1)[1]
    got, step = restore_checkpoint(str(tmp_path / "j"), like)
    assert step == 5
    want = jax.tree_util.tree_flatten_with_path(jtree)[0]
    pairs = tree_flatten_with_path(got)[0]
    assert [keystr(k) for k, _ in pairs] == \
        [jax.tree_util.keystr(k) for k, _ in want]
    for (_, g), (_, w) in zip(pairs, want):
        assert g.dtype == torch.from_numpy(np.asarray(w)).dtype
        assert np.array_equal(g.numpy(), np.asarray(w))
    save_checkpoint(str(tmp_path / "t"), 9, ttree)
    back, step = jckpt.restore_checkpoint(str(tmp_path / "t"),
                                          _train_trees(2)[0])
    assert step == 9
    for g, w in zip(jax.tree.leaves(back), tree_leaves(ttree)):
        assert np.array_equal(np.asarray(g), w.numpy())


def test_restore_places_leaves_and_keeps_requires_grad(tmp_path):
    """Restored leaves go where the template's are (or to ``device``)
    and keep its ``requires_grad``."""
    tree = {"w": torch.ones(3, requires_grad=True), "n": torch.tensor(2)}
    save_checkpoint(str(tmp_path), 1, tree)
    got, _ = restore_checkpoint(str(tmp_path), tree)
    assert got["w"].requires_grad and not got["n"].requires_grad
    got, _ = restore_checkpoint(str(tmp_path), tree, device="cpu")
    assert got["w"].device.type == "cpu"
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(str(tmp_path / "none"), tree)
    with pytest.raises(ValueError, match="mismatch"):
        restore_checkpoint(str(tmp_path), {"w": tree["w"]})


def test_batches_byte_identical_to_reference():
    """Several steps of the stream, its host shards, and make_batch_fn
    with the VLM's and the enc-dec's stub inputs: byte for byte."""
    kw = dict(vocab_size=151936, seq_len=64, global_batch=8, seed=3,
              mean_doc_len=32)
    for host, count in ((0, 1), (0, 2), (1, 2), (3, 4)):
        js = JaxStream(JaxDataConfig(**kw), host, count)
        ts = SyntheticStream(DataConfig(**kw), host, count)
        for step in (0, 1, 7, 1000):
            a, b = js.batch_at(step), ts.batch_at(step)
            assert a.keys() == b.keys()
            for k in a:
                assert a[k].dtype == b[k].dtype and \
                    a[k].tobytes() == b[k].tobytes()
    for arch in ("pixtral-12b", "whisper-small"):
        cfg = get_config(arch, smoke=True)
        extra = ({"patches": (cfg.n_patches, cfg.d_model)}
                 if cfg.family == "vlm"
                 else {"frames": (cfg.enc_frames, cfg.d_model)})
        jf = jax_batch_fn(JaxDataConfig(**kw), extra)
        tf = make_batch_fn(DataConfig(**kw), extra)
        for step in (0, 5):
            a, b = jf(step), tf(step)
            assert a.keys() == b.keys() and len(a) == 3
            for k in a:
                assert a[k].tobytes() == b[k].tobytes()


def test_remat_model_trains_like_plain_one():
    """build_model(remat=True) gives the plain model's loss, gradients
    and decode path (remat applies to the loss only)."""
    from repro_torch.engine import Engine
    cfg = get_config("recurrentgemma-9b", smoke=True)
    cpu = Engine("torch:device=cpu")
    plain = build_model(cfg, engine=cpu)
    remat = build_model(cfg, remat=True, engine=cpu)
    params = plain.init(0)
    for x in tree_leaves(params):
        x.requires_grad_()
    rng = np.random.default_rng(0)
    batch = {k: torch.from_numpy(rng.integers(3, cfg.vocab_size, (2, 12)))
             for k in ("tokens", "labels")}
    grads = [torch.autograd.grad(m.loss(params, batch), tree_leaves(params))
             for m in (plain, remat)]
    for a, b in zip(*grads):
        assert torch.equal(a, b)
