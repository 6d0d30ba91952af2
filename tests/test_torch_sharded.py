"""The port's sharded training on the CPU: gloo groups of spawned ranks
(``tests/_torch_dist.py``) against the unsharded step, the reference's
``compressed_psum`` and the reference's checkpoints.

Every step case starts from the reference's ``init_fn(PRNGKey(0))``,
taken through ``convert.params_from_numpy``.

* The four dense decoders on (data, model) meshes (1, 2), (2, 2) and
  (1, 4) (tensor parallel, Megatron's layout), qwen3-8b on (2, 2) with two
  microbatches and remat, the other six architectures on (1, 2) (expert
  parallelism, channel- and head-parallel recurrent blocks, the VLM's
  patch projection, the enc-dec encoder and cross-attention) and
  deepseek-moe-16b and rwkv6-7b on (2, 2): each rank's leaves are its
  specs' shard shapes; the forward's logits (gathered over the
  vocabulary), one batch's loss and gradients (gathered) and three AdamW
  steps (loss, grad_norm and lr each step; parameters, ``m`` and ``v``
  gathered after the last) against the unsharded step from the same
  parameters.
* All ten architectures on (2, 1) (data parallel, ZeRO-1) with two
  microbatches and int8 error feedback, and qwen3-8b with labels masked
  unevenly across the data ranks.
* Five of those cases against the reference's own sharded step
  (``jit_for`` on a mesh of the same shape over forced host devices, in
  a subprocess): granite-20b on (1, 2), where the single KV head splits,
  qwen3-8b on (2, 1) with two microbatches and error feedback (ZeRO-1),
  and deepseek-moe-16b, rwkv6-7b and whisper-small (its batches with
  their seeded frames) on (1, 2), and the two head-cutting configs on
  (1, 4). Loss, grad_norm and lr each step, the
  gathered parameters after three.
* ``RetryingRunner`` on (2, 2) when one rank alone fails, before a step
  or between two collectives of its forward or backward: every rank
  restores from the same step and the run ends as an uninterrupted one,
  in under 30 s; and when one rank's process is killed inside a step:
  the others raise naming it, re-mesh and continue from the checkpoint.
* ``compressed_psum`` at world sizes 2 and 4 against the reference's
  ``jax.vmap(..., axis_name="i")``, bit for bit; error feedback on
  ZeRO-1 shards against the whole leaves, bit for bit.
* Checkpoints saved on (2, 2) restored on (1, 2) and unsharded, and one
  saved by the reference restored on (2, 2).
* Heads that the model axis does not split (query heads or RWKV heads
  it does not divide, query heads that do not align with the KV
  groups): every smoke config and qwen3-8b with 6 query heads over 2 KV
  heads on (1, 3), the loss and gradients against one rank; and
  whisper-small (2 heads of 32) and rwkv6-7b (2 heads of 32) smoke on
  (1, 4), where a rank's 16 columns cut a head, as step cases against
  one rank and against the reference's sharded step.
* The new collectives, each against one rank on model axes of 2 and 4
  (output, inputs' and leaves' gradients): RWKV-6's time mix with its
  group-norm proxy over the whole ``d_model``, its channel mix's gate,
  and the MLPs whose width is not ``d_ff`` (deepseek-moe-16b's dense
  block and two shared experts).
* PIM scopes on a mesh: qwen3-8b's loss on the PIM path (the LM head,
  then every projection), and one train step quantised in ``"fake"``
  mode, on (2, 1) and (1, 2) against one rank.

Tolerances, with their reasons: only the order of float32 sums changes
(over ranks, and within the shards' matmuls), so logits, gradients,
parameters, ``m`` and ``v`` are held within 1e-5 of each leaf's norm,
and losses and grad norms within 1e-5 relative (the measures of
``tests/test_torch_train.py``); lr
within 1e-6. With error feedback an element of the summed gradient that
sits on an int8 rounding boundary can round the other way: there the
applied gradient, ``m``, ``v`` and the residual differ by one quantum.
Those cases hold the losses, grad norms and lr as above, the parameters
within 1e-4 of each leaf's norm (the measure for parameters after
AdamW of ``tests/test_torch_train_step.py``), and at most 1 in 1,000
elements of ``m``, ``v`` and the residual off (beyond 1e-5 of the leaf's
largest magnitude; half a quantum for the residual). rwkv6-7b's tensor
parallel cases are held the same way: their gradients agree with one
rank's within float noise (1e-6 of each leaf's norm), but an element
of ``wk`` whose gradient is within that noise of 0 (2e-10 against the
leaf's largest, 0.1) takes AdamW's first step, about lr in size, with
the other sign. Against the
reference's sharded step (another package, so every sum differs in
order, and error feedback can round a boundary element the other way):
losses and grad norms within 1e-5 relative and lr within 1e-6, the
parameters within 1e-4 of the whole tree's norm, the measures of
``tests/test_torch_train_step.py``. The runner's two runs are the same
program on the same ranks, so they agree exactly.
"""
import json
import os
import pickle
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_sharded_cases as cases  # noqa: E402
from _torch_dist import run_ranks  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro.optim import adamw as ja  # noqa: E402
from repro.optim.compress import compressed_psum as jax_psum  # noqa: E402
from repro.train import save_checkpoint as jax_save  # noqa: E402

pytestmark = pytest.mark.infra

DENSE = ["deepseek-7b", "qwen3-8b", "gemma2-9b", "granite-20b"]
ALL = DENSE + ["deepseek-moe-16b", "phi3.5-moe-42b-a6.6b", "pixtral-12b",
               "recurrentgemma-9b", "rwkv6-7b", "whisper-small"]
# Smoke configs scaled so that a rank's shard of the attention (or RWKV
# time-mix) leaves cuts a head on (1, 4): 16 columns a rank of 32-wide
# heads. Their blocks run every head on every rank.
HEAD_CUTS = ["whisper-small-h2", "rwkv6-7b-hd32"]
FAMILIES = ["deepseek-moe-16b", "phi3.5-moe-42b-a6.6b", "recurrentgemma-9b",
            "rwkv6-7b", "pixtral-12b", "whisper-small"]
TP_CASES = ([(a, m, 1, False, False, False) for a in DENSE
             for m in ((1, 2), (2, 2), (1, 4))]
            + [("qwen3-8b", (2, 2), 2, False, True, False)]
            + [(a, (1, 2), 1, False, False, False) for a in FAMILIES]
            + [(a, (2, 2), 1, False, False, False)
               for a in ("deepseek-moe-16b", "rwkv6-7b")]
            + [(a, (1, 4), 1, False, False, False) for a in HEAD_CUTS])
# AdamW's first step flips an element whose gradient is float noise
# (see the module docstring): parameters held as with error feedback.
SIGN_NOISE = {"rwkv6-7b", "rwkv6-7b-hd32"}
DP_CASES = ([(a, (2, 1), 2, True, False, False) for a in ALL]
            + [("qwen3-8b", (2, 1), 2, False, True, True)])
REF_CASES = [("granite-20b", (1, 2), 1, False, False, False),
             ("qwen3-8b", (2, 1), 2, True, False, False),
             ("deepseek-moe-16b", (1, 2), 1, False, False, False),
             ("rwkv6-7b", (1, 2), 1, False, False, False),
             ("whisper-small", (1, 2), 1, False, False, False)]
REF_CASES += [(a, (1, 4), 1, False, False, False) for a in HEAD_CUTS]
TOL = 1e-5
PARAM_TOL_EF = 1e-4
OFF_EF = 1e-3
REF_LOSS_RTOL = 1e-5
REF_PARAM_REL = 1e-4
RECOVERY_S = 30.0
ROOT = Path(__file__).resolve().parents[1]

# The reference's sharded train step (``jit_for``) on a (data, model)
# mesh of forced host devices, for each case in argv[1]: the initial
# parameters, loss, grad_norm and lr each step, the parameters after.
_REF_SCRIPT = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import json, pickle, sys
import jax, jax.numpy as jnp
from jax.sharding import Mesh
import numpy as np

sys.path.insert(0, "src")
from repro.configs import get_config
from repro.data import DataConfig, make_batch_fn
from repro.models import build_model
from repro.optim import AdamWConfig
from repro.train import make_train_step

cases, opt_kw, steps = json.loads(sys.argv[1])
out = []
for arch, changes, (dp, tp), mb, compress in cases:
    cfg = get_config(arch, smoke=True).scaled(**changes)
    mesh = Mesh(np.asarray(jax.devices()[:dp * tp]).reshape(dp, tp),
                ("data", "model"))
    _, init_fn, jit_for = make_train_step(
        build_model(cfg), AdamWConfig(**opt_kw), mesh, microbatches=mb,
        compress_grads=compress)
    p, o, r = init_fn(jax.random.PRNGKey(0))
    init = [np.asarray(x).copy() for x in jax.tree.leaves(p)]
    extra = {}
    if cfg.family == "vlm":
        extra["patches"] = (cfg.n_patches, cfg.d_model)
    if cfg.family == "encdec":
        extra["frames"] = (cfg.enc_frames, cfg.d_model)
    bf = make_batch_fn(DataConfig(vocab_size=cfg.vocab_size, seq_len=16,
                                  global_batch=8), extra)
    step = jit_for(p, jax.tree.map(jnp.asarray, bf(0)))
    trace = []
    for s in range(steps):
        p, o, r, m = step(p, o, r, jax.tree.map(jnp.asarray, bf(s)))
        trace.append({k: float(v) for k, v in m.items()})
    out.append({"init": init, "trace": trace,
                "final": [np.asarray(x) for x in jax.tree.leaves(p)]})
with open(sys.argv[2], "wb") as f:
    pickle.dump(out, f)
"""


def _ids(case):
    arch, (dp, tp), mb, compress, remat, uneven = case
    return (f"{arch}-{dp}x{tp}" + (f"-mb{mb}" if mb > 1 else "")
            + ("-ef" if compress else "") + ("-remat" if remat else "")
            + ("-uneven" if uneven else ""))


@pytest.fixture(scope="module")
def ref_inits(tmp_path_factory):
    """The reference's ``init_fn(PRNGKey(0))`` of each architecture, a
    pickled numpy tree each, and the leaves."""
    root = tmp_path_factory.mktemp("ref_init")
    leaves = {}
    for arch in ALL + HEAD_CUTS:
        base, changes = cases.SCALED.get(arch, (arch, {}))
        p = jax_build(jax_config(base, smoke=True).scaled(**changes)).init(
            jax.random.PRNGKey(0))
        tree = jax.tree.map(np.asarray, p)
        with open(root / f"{arch}.pkl", "wb") as f:
            pickle.dump(tree, f)
        leaves[arch] = jax.tree.leaves(tree)
    return str(root), leaves


@pytest.fixture(scope="module")
def ref_sharded(tmp_path_factory):
    """The reference's sharded steps of ``REF_CASES``, in a subprocess
    that runs while the rank groups do; the test collects it."""
    tmp = tmp_path_factory.mktemp("ref_sharded")
    script = tmp / "ref_sharded.py"
    script.write_text(_REF_SCRIPT)
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    arg = json.dumps([[list(cases.SCALED.get(c[0], (c[0], {}))) + list(c[1:4])
                       for c in REF_CASES], cases.OPT, 3])
    proc = subprocess.Popen(
        [sys.executable, str(script), arg, str(tmp / "out.pkl")],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        cwd=str(ROOT), env=env)
    yield proc, tmp / "out.pkl"
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


@pytest.fixture(scope="module")
def tp_results(ref_sharded, ref_inits):
    return run_ranks(cases.step_cases, 4, TP_CASES, ref_inits[0], REF_CASES)


@pytest.fixture(scope="module")
def dp_results(ref_sharded, ref_inits):
    return run_ranks(cases.step_cases, 2, DP_CASES, ref_inits[0], REF_CASES)


def _check(case, per_rank):
    arch, (dp, tp), _, compress, _, _ = case
    mine = [r for r in per_rank if r is not None]
    assert len(mine) == dp * tp
    for r in mine:
        assert r["shapes_ok"], "a placed leaf is not its spec's shard"
        assert r["count"] == 3
        for k in ("logits", "grad", "loss", "grad_norm"):
            assert r[k] <= TOL, (k, r[k])
        assert r["lr"] <= 1e-6
        if compress or arch in SIGN_NOISE:
            assert r["params"] <= PARAM_TOL_EF, r["params"]
            for k in ("m_off", "v_off") + (("residual_off",) if compress
                                           else ()):
                assert r[k] <= OFF_EF, (k, r[k])
        else:
            for k in ("params", "m", "v"):
                assert r[k] <= TOL, (k, r[k])


@pytest.mark.parametrize("i", range(len(TP_CASES)),
                         ids=[_ids(c) for c in TP_CASES])
def test_tensor_parallel_step_matches_unsharded(tp_results, i):
    """Every architecture on meshes with a model axis (and data on
    (2, 2)): shard shapes, logits, loss, gradients and three AdamW
    steps."""
    _check(TP_CASES[i], [rank[i] for rank in tp_results])


@pytest.mark.parametrize("i", range(len(DP_CASES)),
                         ids=[_ids(c) for c in DP_CASES])
def test_data_parallel_step_matches_unsharded(dp_results, i):
    """Every architecture on (2, 1) with ZeRO-1, two microbatches and
    error feedback; and qwen3-8b with uneven masks, where a mean of the
    ranks' means would differ from the global mean."""
    _check(DP_CASES[i], [rank[i] for rank in dp_results])


@pytest.mark.parametrize("i", range(len(REF_CASES)),
                         ids=[_ids(c) for c in REF_CASES])
def test_sharded_step_matches_reference_sharded_step(ref_sharded, ref_inits,
                                                     tp_results, dp_results,
                                                     i):
    """The port's sharded step against the reference's ``jit_for`` on a
    mesh of the same shape, from the same parameters: loss, grad_norm
    and lr each step, the gathered parameters after three steps."""
    proc, path = ref_sharded
    _, err = proc.communicate(timeout=600)
    assert proc.returncode == 0, err[-3000:]
    with open(path, "rb") as f:
        want = pickle.load(f)[i]
    case = REF_CASES[i]
    for a, b in zip(want["init"], ref_inits[1][case[0]]):
        np.testing.assert_array_equal(a, b)     # the same start
    results = tp_results if case in TP_CASES else dp_results
    idx = (TP_CASES if case in TP_CASES else DP_CASES).index(case)
    got = [rank[idx] for rank in results if rank[idx] is not None]
    got = [r for r in got if "trace" in r]
    assert len(got) == 1
    got = got[0]
    assert len(got["trace"]) == len(want["trace"]) == 3
    for g, w in zip(got["trace"], want["trace"]):
        for k in ("loss", "grad_norm"):
            assert abs(g[k] - w[k]) <= REF_LOSS_RTOL * abs(w[k]), (k, g, w)
        assert abs(g["lr"] - w["lr"]) <= 1e-6 * abs(w["lr"]), (g, w)
    a = np.concatenate([np.ravel(x) for x in got["final"]]).astype(np.float64)
    b = np.concatenate([np.ravel(x) for x in want["final"]]).astype(
        np.float64)
    assert np.linalg.norm(a - b) <= REF_PARAM_REL * np.linalg.norm(b)


@pytest.fixture(scope="module")
def misc_results(tmp_path_factory):
    """One world-4 group: compressed_psum, error feedback on shards,
    checkpoints and refusals; the reference's inputs made here."""
    rng = np.random.default_rng(11)
    stacked = (rng.standard_normal((4, 3, 257)) * 1e-2).astype(np.float32)
    ref_dir = str(tmp_path_factory.mktemp("ref_ckpt"))
    jcfg = jax_config("qwen3-8b", smoke=True)
    jp = jax_build(jcfg).init(jax.random.PRNGKey(0))
    jo = ja.adamw_init(jp)
    jax_save(ref_dir, 0, {"params": jp, "opt": jo})
    want_leaves = [np.asarray(x) for x in
                   jax.tree.leaves({"params": jp, "opt": jo})]
    root = str(tmp_path_factory.mktemp("ckpt"))
    out = run_ranks(cases.misc_cases, 4, stacked, root, ref_dir)
    return out, stacked, want_leaves


def test_compressed_psum_matches_reference_at_world_2_and_4(misc_results):
    """Each rank's mean equals the reference's ``vmap`` over the stacked
    inputs, bit for bit, at world size 4 and on a group of two."""
    out, stacked, _ = misc_results
    for n in (4, 2):
        want = np.asarray(jax.vmap(lambda g: jax_psum(g, "i"),
                                   axis_name="i")(jnp.asarray(stacked[:n])))
        for r in range(n):
            got = out[r]["psum"][0 if n == 4 else 1]
            np.testing.assert_array_equal(got, want[r])


def test_error_feedback_on_shards_takes_the_whole_leafs_scale(misc_results):
    """``ef_compress_tree`` on ZeRO-1 shards over (2, 2), gathered,
    equals it on the whole leaves bit for bit: each scale is the whole
    leaf's largest magnitude."""
    out, _, _ = misc_results
    assert all(r["compress"] == 0.0 for r in out)


def test_checkpoint_restores_across_mesh_shapes(misc_results):
    """Saved on (2, 2) after a step: restored on (1, 2) and unsharded,
    every leaf equals the saved one; parameters still train."""
    out, _, _ = misc_results
    saved = out[0]["ckpt"]["saved"]
    for r in (0, 1):
        ck = out[r]["ckpt"]
        assert ck["on_1x2_step"] == 1 and ck["requires_grad"]
        for a, b in zip(ck["on_1x2"], saved):
            np.testing.assert_array_equal(a, b)
    for a, b in zip(out[0]["ckpt"]["on_1x1"], saved):
        np.testing.assert_array_equal(a, b)
    assert "on_1x2" not in out[2]["ckpt"]


def test_reference_checkpoint_restores_sharded(misc_results):
    """A checkpoint the reference wrote restores on (2, 2): each rank's
    leaves have its shard's shape, and gathered they are the
    reference's."""
    out, _, want = misc_results
    for r in range(4):
        ck = out[r]["ckpt"]
        assert ck["shard_shapes"] == ck["like_shapes"]
        assert len(ck["reference_on_2x2"]) == len(want)
        for a, b in zip(ck["reference_on_2x2"], want):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", list(cases.ARCHS) + ["qwen3-8b-6x2"])
def test_indivisible_heads_match_one_rank(misc_results, name):
    """On a model axis of 3 every architecture's smoke config runs (4
    query heads, and 4 RWKV heads of d_model 64 / 16, do not split 3
    ways), and so does qwen3-8b with 6 query heads over 2 KV heads (2
    query heads a rank do not align with groups of 3, and ``wq``'s 96
    columns split into shards that cut heads): the loss and the gathered
    gradients of one batch equal one rank's within 1e-5."""
    out, _, _ = misc_results
    assert out[3]["indivisible"] is None
    for r in (0, 1, 2):
        loss, grad = out[r]["indivisible"][name]
        assert loss <= TOL and grad <= TOL, (r, loss, grad)


@pytest.mark.parametrize("piece", ["rwkv_norm", "channel_gate",
                                   "mlp_width_shared", "mlp_width_d"])
def test_tensor_parallel_pieces_match_one_rank(misc_results, piece):
    """On model axes of 2 and 4, against one rank (output, the inputs'
    gradients and the leaves', gathered, under a seeded cotangent):
    ``rwkv_norm``, RWKV-6's time mix with one rank's value heads scaled
    by 10, so only a group-norm proxy over the whole ``d_model`` (its
    mean square summed over the ranks) agrees; ``channel_gate``, its
    channel mix (``cr``'s gate gathered whole, ``cv``'s product summed);
    ``mlp_width_shared`` and ``mlp_width_d``, deepseek-moe-16b's shared
    experts at 2 x d_ff and its dense block at ``d_ff_dense``, split at
    their own widths (not ``cfg.d_ff``'s)."""
    out, _, _ = misc_results
    seen = set()
    for r in out:
        for (tp, name), errs in r["tp_pieces"].items():
            if name == piece:
                seen.add(tp)
                for k, v in errs.items():
                    assert v <= TOL, (tp, k, v)
    assert seen == {2, 4}


def test_pim_scoped_loss_and_step_on_a_mesh_match_one_rank(misc_results):
    """qwen3-8b smoke on the PIM path (the LM head alone, and every block
    projection too): the loss under ``pim_linear_mode="pim"`` (its scales
    the whole tensors', over the data ranks' rows and, row-parallel, the
    model ranks' columns) and one train step under ``"fake"`` (the
    scales' gradients reduced with them) on (2, 1) and (1, 2), against
    one rank: losses and the step's grad_norm within 1e-5 relative."""
    out, _, _ = misc_results
    meshes = set()
    for r in out:
        mesh, got = r["pim_train"]
        meshes.add(tuple(mesh))
        assert set(got) == {(m, b) for m in ("pim", "fake")
                            for b in ("none", "full")}
        for key, (sharded, one) in got.items():
            for a, b in zip(sharded, one):
                assert abs(a - b) <= TOL * abs(b), (mesh, key, sharded, one)
    assert meshes == {(2, 1), (1, 2)}


def _held_to_whole(out, name):
    """Every rank of run ``name`` counts one restart, replays step 2, and
    gives the uninterrupted run's losses and final parameters exactly."""
    whole = out[0]["runner"]["whole"]
    assert [s for s, _ in whole["seen"]] == [0, 1, 2, 3, 4]
    assert whole["restarts"] == 0
    losses = dict(whole["seen"])
    for r in range(4):
        run = out[r]["runner"][name]
        assert run["restarts"] == 1
        assert [s for s, _ in run["seen"]] == [0, 1, 2, 2, 3, 4]
        assert all(loss == losses[s] for s, loss in run["seen"])
        assert run["seen"] == out[0]["runner"][name]["seen"]
    assert out[3]["runner"][name]["fired"] == [3]
    for a, b in zip(out[0]["runner"][name]["final"], whole["final"]):
        np.testing.assert_array_equal(a, b)


def test_runner_restores_every_rank_when_one_fails(misc_results):
    """On (2, 2) with checkpoints every 2 steps, rank 3 alone raises
    before step 3: every rank counts one restart, restores step 2 and
    replays it, and the run's losses and final parameters equal the
    uninterrupted run's exactly."""
    out, _, _ = misc_results
    _held_to_whole(out, "before")


def test_runner_without_a_fence_agrees_between_phases(misc_results):
    """As above with no fence armed, as on a backend other than gloo
    (NCCL): the ranks gather who failed after each phase, and every rank
    restores and replays with the uninterrupted run's losses and
    parameters exactly; no recovery goes through the store."""
    out, _, _ = misc_results
    _held_to_whole(out, "unfenced")
    for r in range(4):
        assert out[r]["runner"]["unfenced"]["recovery_s"][0] < RECOVERY_S


@pytest.mark.parametrize("where", ["forward", "backward"])
def test_runner_restores_every_rank_when_one_fails_inside_a_step(
        misc_results, where):
    """As above, but rank 3 raises between two all-reduces of step 3's
    forward (or backward) while the others wait in a collective: they
    leave it on the fault rank 3 posts in the store, and every rank
    restores and replays in under 30 s (the group timeout is 120 s), with
    the uninterrupted run's losses and parameters exactly."""
    out, _, _ = misc_results
    _held_to_whole(out, where)
    for r in range(4):
        run = out[r]["runner"][where]
        assert len(run["recovery_s"]) == 1
        assert run["recovery_s"][0] < RECOVERY_S, run["recovery_s"]
        assert run["wall_s"] - out[r]["runner"]["whole"]["wall_s"] \
            < RECOVERY_S


def test_lost_rank_raises_on_every_survivor_and_remeshes(tmp_path):
    """In a group of 4 on (2, 2), rank 3 is SIGKILLed at an all-reduce of
    step 3's forward. Ranks 0-2 each raise ``RanksLost`` naming rank 3
    within 30 s (its heartbeat in the store stops; the group timeout is
    120 s), re-mesh with ``elastic_remesh`` to (3, 1), restore the step-2
    checkpoint sharded for it and train on: their losses continue the
    uninterrupted (2, 2) run's within 1e-5 relative (the measure of
    ``tests/test_torch_elastic.py``: only the order of the sums over
    ranks changes)."""
    out = run_ranks(cases.kill_case, 4, str(tmp_path), may_die=(3,))
    assert out[3] is None
    for r in range(3):
        got = out[r]
        assert got["lost"] == (3,), got["error"]
        assert "[3]" in got["error"]
        assert got["noticed_s"] < RECOVERY_S, got["noticed_s"]
        assert got["mesh"] == {"data": 3, "model": 1}
        assert got["restored"] == 2
        whole = dict(got["whole"])
        assert [s for s, _ in got["after"]] == [2, 3, 4, 5]
        for s, loss in got["after"]:
            assert abs(loss - whole[s]) <= 1e-5 * abs(whole[s]), (s, loss,
                                                                  whole[s])
        assert got["after"] == out[0]["after"]
