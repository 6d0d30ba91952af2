"""The port's sharded serving on the CPU: gloo groups of spawned ranks
(``tests/_torch_dist.py``, rank functions in
``tests/_torch_serve_cases.py``) against one rank and against the
reference's sharded serve step.

Every case starts from the reference's ``init(PRNGKey(0))``, through
``convert.params_from_numpy``, with batch 4 (or 3), prompt 8, cache 32
and 4 greedy decode steps through ``make_serve_step``.

Each case also runs ``make_prefill(model, mesh)``, which must give one
rank's first token.

* Tensor parallel on (1, 2): gemma2-9b, qwen3-8b and deepseek-7b (their
  caches split over KV heads) and granite-20b (one KV head: its caches
  split over the sequence), with PIM off and with every projection on
  the PIM path at 8 bits; deepseek-moe-16b (experts over the model
  axis), also with PIM, phi3.5-moe, recurrentgemma-9b (RG-LRU states
  over channels, its local layer's single KV head over the sequence),
  rwkv6-7b (wkv over heads, token shifts over channels), pixtral-12b and
  whisper-small (its encoder split too, ``enc_out`` whole).
* Data parallel on (2, 1): all ten architectures with PIM off,
  gemma2-9b, deepseek-moe-16b (the ragged expert path) and rwkv6-7b
  with PIM, and qwen3-8b at batch 3, which the data axis does not split.
* (2, 2) on four ranks: gemma2-9b, granite-20b and deepseek-moe-16b
  with PIM.
* What the model axis does not divide: heads, run whole on every rank
  (whisper-small smoke with 2 heads of 32 on (1, 4), a rank's 16 columns
  cutting a head, caches over the sequence; qwen3-8b smoke with 6 query
  heads over 2 KV heads on (1, 3)), and caches of 32 slots whole on
  every rank of (1, 3) (that qwen3-8b, and granite-20b smoke with 6
  query heads over one KV head, 2 a rank).
* Against the reference's sharded serving (its ``make_serve_step(model,
  mesh)`` ``jit_for`` on forced host devices, in a subprocess, after its
  launcher's unsharded prefill): gemma2-9b on (1, 2) and (2, 2) with
  PIM, granite-20b on (1, 2), rwkv6-7b on (2, 1), deepseek-moe-16b
  with PIM, recurrentgemma-9b and rwkv6-7b on (1, 2), and the three
  cases the axis does not divide.
* Pieces: the argmax over vocabulary shards with planted ties, the
  sequence-split attention combine against ``decode_attend`` on the whole
  cache, the PIM scales and the row-parallel integer product on shards,
  the shard-by-shard init against ``shard_leaf`` of the whole init,
  the expert-parallel PIM dispatch (``ragged_linear`` with ``k_group``)
  against one rank bit for bit, and a windowed ring split over the
  sequence (recurrentgemma-9b, window 12 under a cache of 32).
* Bytes: each rank's parameters and decode states equal the dry-run's
  count for its mesh, batch and cache length.
* The launcher on two ranks under ``torch.distributed.run``.

Tolerances, with their reasons: the tokens are equal. Float logits are
within 1e-5 of one rank's largest logit and the caches (gathered) within
1e-5 of each leaf's largest value: only the order of float32 sums
changes (over ranks, and the split softmax). With PIM the logits are
within 1e-3 (``tests/test_torch_block_pim.py``'s bound: an activation
that differs in its last bit can round to another 8-bit level; the PIM
projections take the whole tensors' scales and sum exact integers, so
the cases here agree far closer). Against the reference (another
package, so every sum differs in order): the tokens equal at every step
and the final caches within 1e-4 of each leaf's largest value.
"""
import json
import os
import pickle
import signal
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_serve_cases as cases  # noqa: E402
from _torch_dist import run_ranks  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import serve as launcher  # noqa: E402
from repro_torch.launch.dryrun import (_tree_bytes,  # noqa: E402
                                       abstract_states)
from repro_torch.launch.mesh import abstract_mesh  # noqa: E402
from repro_torch.models.model import abstract_params  # noqa: E402
from repro_torch.train.sharding import (param_shardings,  # noqa: E402
                                        state_shardings)

pytestmark = pytest.mark.infra

DENSE = ["gemma2-9b", "qwen3-8b", "deepseek-7b", "granite-20b"]
ALL = DENSE + ["deepseek-moe-16b", "phi3.5-moe-42b-a6.6b", "pixtral-12b",
               "recurrentgemma-9b", "rwkv6-7b", "whisper-small"]
FAMILIES = ["deepseek-moe-16b", "phi3.5-moe-42b-a6.6b", "recurrentgemma-9b",
            "rwkv6-7b", "pixtral-12b", "whisper-small"]
TP_CASES = ([(a, (1, 2), pim, 4) for a in DENSE for pim in (False, True)]
            + [(a, (1, 2), False, 4) for a in FAMILIES]
            + [("deepseek-moe-16b", (1, 2), True, 4)])
DP_CASES = ([(a, (2, 1), False, 4) for a in ALL]
            + [(a, (2, 1), True, 4) for a in ("gemma2-9b",
                                                "deepseek-moe-16b",
                                                "rwkv6-7b")]
            + [("qwen3-8b", (2, 1), False, 3)])
FOUR_CASES = [(a, (2, 2), True, 4) for a in ("gemma2-9b", "granite-20b",
                                               "deepseek-moe-16b")]
# What the model axis does not divide: heads, run whole on every rank
# (whisper-small smoke with 2 heads of 32 on (1, 4), where 16 columns a
# rank cut a head, its caches over the sequence; qwen3-8b smoke with 6
# query heads over 2 KV heads on (1, 3), 2 a rank not aligned with groups
# of 3), and caches of 32 slots whole on every rank of (1, 3) (that
# qwen3-8b, and granite-20b smoke with 6 query heads over its one KV
# head, whose heads split 2 a rank).
UNEVEN_CASES = [("whisper-small-h2", (1, 4), False, 4),
                ("qwen3-8b-6x2", (1, 3), False, 4),
                ("granite-20b-6x1", (1, 3), False, 4)]
CASES = TP_CASES + DP_CASES + FOUR_CASES + UNEVEN_CASES
# (1, 2) on ranks 0-1 while (2, 1) runs on ranks 2-3, then (2, 2), (1, 4)
# and (1, 3) on ranks 0-2.
PLACEMENT = [((1, 2), [0, 1]), ((2, 1), [2, 3]), ((2, 2), [0, 1, 2, 3]),
             ((1, 4), [0, 1, 2, 3]), ((1, 3), [0, 1, 2])]
REF_CASES = [("gemma2-9b", (1, 2), True), ("gemma2-9b", (2, 2), True),
             ("granite-20b", (1, 2), False), ("rwkv6-7b", (2, 1), False),
             ("deepseek-moe-16b", (1, 2), True),
             ("recurrentgemma-9b", (1, 2), False),
             ("rwkv6-7b", (1, 2), False)]
REF_CASES += [(a, m, pim) for a, m, pim, _ in UNEVEN_CASES]
FLOAT_TOL = 1e-5
PIM_TOL = 1e-3
REF_CACHE_TOL = 1e-4
ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"

# The reference's sharded serving for each case in argv[1]: its
# launcher's unsharded prefill, then its make_serve_step(model, mesh)
# jit_for on a (data, model) mesh of forced host devices; the tokens and
# the final decode states.
_REF_SCRIPT = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import dataclasses, json, pickle, sys
import jax, jax.numpy as jnp
from jax.sharding import Mesh
import numpy as np

sys.path.insert(0, "src")
from repro.configs import get_config
from repro.models import build_model
from repro.train import make_serve_step

todo, cache, steps = json.loads(sys.argv[1])
out = []
for arch, changes, (dp, tp), pim, prompts in todo:
    cfg = get_config(arch, smoke=True).scaled(**changes)
    if pim:
        cfg = dataclasses.replace(cfg, pim_linear_mode="pim",
                                  pim_linear_bits=8, pim_block_mode="full")
    model = build_model(cfg)
    params = model.init(jax.random.PRNGKey(0))
    mesh = Mesh(np.asarray(jax.devices()[:dp * tp]).reshape(dp, tp),
                ("data", "model"))
    prompts = jnp.asarray(np.asarray(prompts, np.int32))
    b, s = prompts.shape
    states = model.init_decode_state(b, cache)
    logits, states = model.forward(params, prompts, states=states)
    tok = jnp.argmax(logits[:, -1:], axis=-1).astype(jnp.int32)
    _, jit_for = make_serve_step(model, mesh)
    step = jit_for(params, states, {"token": tok,
                                    "position": jnp.zeros((b, 1), jnp.int32)})
    toks = [np.asarray(tok)]
    for t in range(steps):
        tok, states = step(params, states, tok,
                           jnp.full((b, 1), s + t, jnp.int32))
        toks.append(np.asarray(tok))
    out.append({"tokens": np.concatenate(toks, axis=1),
                "states": [np.asarray(x) for x in jax.tree.leaves(states)]})
with open(sys.argv[2], "wb") as f:
    pickle.dump(out, f)
"""


@pytest.fixture(scope="module")
def ref_inits(tmp_path_factory):
    """The reference's ``init(PRNGKey(0))`` of each architecture, a
    pickled numpy tree each."""
    root = tmp_path_factory.mktemp("ref_init")
    for arch in ALL + [a for a, _, _, _ in UNEVEN_CASES]:
        base, changes = cases.SCALED.get(arch, (arch, {}))
        p = jax_build(jax_config(base, smoke=True).scaled(**changes)).init(
            jax.random.PRNGKey(0))
        with open(root / f"{arch}.pkl", "wb") as f:
            pickle.dump(jax.tree.map(np.asarray, p), f)
    return str(root)


@pytest.fixture(scope="module")
def ref_serving(tmp_path_factory):
    """The reference's sharded serving of ``REF_CASES``, in a subprocess
    that runs while the ranks do; a test collects it."""
    tmp = tmp_path_factory.mktemp("ref_serving")
    script = tmp / "ref_serving.py"
    script.write_text(_REF_SCRIPT)
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    todo = [list(cases.SCALED.get(a, (a, {}))) + [
        list(m), pim, cases.inputs(cases.config(a, pim), 4)[0].tolist()]
        for a, m, pim in REF_CASES]
    proc = subprocess.Popen(
        [sys.executable, str(script),
         json.dumps([todo, cases.CACHE, cases.STEPS]),
         str(tmp / "out.pkl")],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        cwd=str(ROOT), env=env)
    yield proc, tmp / "out.pkl"
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


@pytest.fixture(scope="module")
def results(ref_serving, ref_inits):
    return run_ranks(cases.all_cases, 4, CASES, ref_inits, PLACEMENT, ALL)


def _ids(case):
    arch, (dp, tp), pim, batch = case
    return (f"{arch}-{dp}x{tp}" + ("-pim" if pim else "")
            + (f"-b{batch}" if batch != 4 else ""))


def _per_rank(results, i):
    return [r["serve"][i] for r in results if r["serve"][i] is not None]


def _check(case, got):
    arch, (dp, tp), pim, _ = case
    assert len(got) == dp * tp
    for r in got:
        assert r["tokens_equal"] and r["prefill_equal"], r["tokens"]
        assert r["logits"] <= (PIM_TOL if pim else FLOAT_TOL), r["logits"]
        assert r["caches"] <= FLOAT_TOL, r["caches"]
    for r in got[1:]:
        np.testing.assert_array_equal(r["tokens"], got[0]["tokens"])


@pytest.mark.parametrize("i", range(len(TP_CASES)),
                         ids=[_ids(c) for c in TP_CASES])
def test_tensor_parallel_serving_matches_one_rank(results, i):
    """(1, 2): the dense decoders' caches split over KV heads, granite's
    and recurrentgemma's local layer's over the sequence, the MoE
    experts over the model axis, the recurrent states over heads or
    channels; tokens, logits and caches after prefill and every step
    against one rank."""
    _check(TP_CASES[i], _per_rank(results, i))


@pytest.mark.parametrize("i", range(len(DP_CASES)),
                         ids=[_ids(c) for c in DP_CASES])
def test_data_parallel_serving_matches_one_rank(results, i):
    """(2, 1): every architecture, three with PIM (a scale over both
    ranks' rows), and a batch of 3 that stays whole on each rank."""
    j = len(TP_CASES) + i
    _check(DP_CASES[i], _per_rank(results, j))


@pytest.mark.parametrize("i", range(len(FOUR_CASES)),
                         ids=[_ids(c) for c in FOUR_CASES])
def test_four_rank_serving_matches_one_rank(results, i):
    """(2, 2) with PIM: rows over data, heads, slots or experts over
    model."""
    j = len(TP_CASES) + len(DP_CASES) + i
    _check(FOUR_CASES[i], _per_rank(results, j))


@pytest.mark.parametrize("i", range(len(UNEVEN_CASES)),
                         ids=[_ids(c) for c in UNEVEN_CASES])
def test_indivisible_serving_matches_one_rank(results, i):
    """Heads that the model axis does not split run whole on every rank,
    and a cache it splits over neither its KV heads nor its slots is
    whole on every rank (each rank writing every KV head, gathered, and
    attending its own): tokens, logits and caches after prefill and every
    step against one rank."""
    j = len(TP_CASES) + len(DP_CASES) + len(FOUR_CASES) + i
    _check(UNEVEN_CASES[i], _per_rank(results, j))


@pytest.mark.parametrize("i", range(len(REF_CASES)),
                         ids=[_ids(c + (4,)) for c in REF_CASES])
def test_sharded_serving_matches_reference_sharded_serving(ref_serving,
                                                           results, i):
    """The port's sharded tokens equal the reference's sharded
    ``jit_for`` at every step, and its gathered final caches are within
    1e-4 of the reference's."""
    proc, path = ref_serving
    _, err = proc.communicate(timeout=600)
    assert proc.returncode == 0, err[-3000:]
    with open(path, "rb") as f:
        want = pickle.load(f)[i]
    arch, mesh, pim = REF_CASES[i]
    got = _per_rank(results, CASES.index((arch, mesh, pim, 4)))
    np.testing.assert_array_equal(got[0]["tokens"], want["tokens"])
    final = [r["final_states"] for r in got if r["final_states"]]
    assert len(final) == 1 and len(final[0]) == len(want["states"])
    for a, b in zip(final[0], want["states"]):
        a, b = a.astype(np.float64), b.astype(np.float64)
        assert np.abs(a - b).max() <= REF_CACHE_TOL * max(
            np.abs(b).max(), 1e-30)


@pytest.mark.parametrize("i", range(len(CASES)),
                         ids=[_ids(c) for c in CASES])
def test_placed_bytes_equal_the_dry_run_count(results, i):
    """Each rank's parameter and decode-state bytes equal the dry-run's
    ``_tree_bytes`` of them under ``param_shardings`` and
    ``state_shardings`` for the same mesh, batch and cache length."""
    arch, shape, pim, batch = CASES[i]
    cfg = cases.config(arch, pim)
    mesh = abstract_mesh(shape, cases.AXES)
    params = abstract_params(cfg, torch.float32)
    states = abstract_states(cfg, batch, cases.CACHE, torch.float32)
    want = [_tree_bytes(mesh, params, param_shardings(mesh, params)),
            _tree_bytes(mesh, states, state_shardings(mesh, states))]
    for r in _per_rank(results, i):
        assert r["bytes"] == want


def test_argmax_over_vocabulary_shards_takes_the_first_maximum(results):
    """Ties planted across a shard boundary and inside a shard: the
    token is the lowest maximal index, as ``torch.argmax`` gives it."""
    n = 256 // 4                    # the smoke vocabulary over 4 ranks
    for r in results:
        got, want = r["pieces"]["argmax"]
        assert got == want == [n - 1, 2 * n + 7, n + 3]


def test_sequence_split_combine_matches_decode_attend(results):
    """A ring of 32 slots split over 4 ranks, window 12, softcap 50, the
    length past a wrap: the output and the new cache equal
    ``decode_attend`` on the whole cache within float noise."""
    for r in results:
        errs, length_ok = r["pieces"]["combine"]
        assert length_ok and max(errs) <= FLOAT_TOL, errs


def test_pim_scales_and_row_parallel_product_on_shards(results):
    """On (2, 2): the amaxes reduced from the shards are the whole
    tensors', the row-parallel PIM product equals one rank's rows bit
    for bit, and the float one within float noise."""
    for r in results:
        scales, exact, float_err = r["pieces"]["quant"]
        assert scales and exact and float_err <= FLOAT_TOL


def test_expert_parallel_pim_dispatch_matches_one_rank(results):
    """On (2, 2), tokens over ``data`` and experts over ``model``:
    ``ragged_linear`` in ``pim`` mode with ``x_group``/``k_group`` takes
    the whole stack's and every routed row's scales, and each rank's
    rows equal one rank's rows of the same pairs bit for bit; also when
    every pair is routed to one model rank's experts and the other holds
    no row."""
    for r in results:
        runs = r["pieces"]["ragged"]
        assert len(runs) == 2
        for scales, exact, _ in runs:
            assert scales and exact
    assert any(n == 0 for r in results for _, _, n in r["pieces"]["ragged"])


def test_windowed_ring_split_over_the_sequence(results):
    """recurrentgemma-9b smoke with a window of 12 under a cache of 32 on
    (1, 4): the local layer's ring of 12 slots split 3 a rank, a prompt
    of 16 rotated into it, 6 steps wrapping it; the tokens equal one
    rank's, the logits and gathered caches within float noise."""
    for r in results:
        tokens_equal, logits, caches = r["pieces"]["ring"]
        assert tokens_equal and logits <= FLOAT_TOL and caches <= FLOAT_TOL


def test_init_shard_by_shard_equals_sharded_whole_init(results):
    """``model.init(0, mesh=...)`` on (2, 2) equals ``shard_leaf`` of the
    whole ``model.init(0)`` leaf for leaf, for every architecture."""
    for r in results:
        assert r["pieces"]["init"] == {a: True for a in ALL}


def test_launcher_sharded_serving_gives_one_ranks_tokens(tmp_path):
    """Two ranks under ``python -m torch.distributed.run`` on the CPU
    (gloo), ``--model-parallel 2``: the tokens of the one-rank run, each
    rank's bytes the dry-run's, no recompile on either rank."""
    args = ["--arch", "gemma2-9b", "--smoke", "--pim-backend",
            "torch:device=cpu", "--gen", "6"]
    one = launcher.main(args)
    out = tmp_path / "summary.json"
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1")
    proc = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "repro_torch.launch.serve"]
        + args + ["--model-parallel", "2", "--dist-backend", "gloo",
                  "--summary", str(out)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
        start_new_session=True)
    try:
        _, err = proc.communicate(timeout=300)
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.communicate()
    assert proc.returncode == 0, err[-3000:]
    got = json.loads(out.read_text())
    assert got["mesh"] == {"data": 1, "model": 2}
    np.testing.assert_array_equal(np.asarray(got["tokens"]), one.tokens)
    assert got["rank_recompiles"] == [0, 0]
    cfg = get_config("gemma2-9b", smoke=True)
    mesh = abstract_mesh((1, 2), cases.AXES)
    params = abstract_params(cfg, torch.float32)
    assert got["param_bytes"] == [_tree_bytes(
        mesh, params, param_shardings(mesh, params))] * 2
