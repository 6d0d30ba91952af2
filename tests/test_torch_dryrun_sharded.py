"""The dry-run's per-rank records against real sharded steps on the CPU.

A record on a mesh of more than one device is rank 0's real sharded step
traced in a fake world of the mesh's ranks (``repro_torch.dist.
fake_world``, on fake tensors). Here each record of the cases in
``tests/_torch_dryrun_cases.py`` (smoke widths; made in a process of its
own) is held against ``dryrun.real_step(mesh=...)`` on every rank of a
gloo group of four (``tests/_torch_dist.py``): each (1, 2) case runs on
ranks 0-1 and on ranks 2-3, each (2, 2) and (1, 4) case on all four.
The other fake-world traces run in processes of their own beside the
ranks: rank 0 against the last rank of 16 x 16, the extrapolation from
2 and 3 units on a rank of (1, 2), and the production records of every
architecture on both production meshes.

Tolerances, with their reasons: collective bytes by kind, argument bytes
and FLOPs are exact (the real step's FLOPs from ``FlopCounterMode``,
its collectives counted in ``repro_torch.dist``'s wrappers, apart from
the trace); temp bytes within 0.5% of a real step's live bytes above
its arguments (``tests/test_torch_dryrun.py``'s tolerance on one
device; a decode step's ``position + i`` is the only difference here).
The MoE on a model axis routes its pairs to the ranks that hold their
experts, which depends on the data, where the trace takes the routing
balanced: its FLOPs are held summed over a mesh's ranks (exact) and its
temp bytes as the mean of a mesh's ranks (within 0.5%). The sharded
decode with a cache split over the sequence and a KV head shared by two
ranks (two KV heads over four model ranks) is held against one process:
tokens equal, logits and caches within 1e-5 of the largest value, as
``tests/test_torch_serve_sharded.py`` holds float serving.
"""
import concurrent.futures
import multiprocessing
import sys

import pytest

torch = pytest.importorskip("torch")

import _torch_dryrun_cases as cases  # noqa: E402
from _torch_dist import run_ranks  # noqa: E402
from repro_torch import dist  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import abstract_mesh  # noqa: E402

REFERENCE_KINDS = {"all-reduce", "all-gather", "reduce-scatter",
                   "all-to-all", "collective-permute"}
CASE_IDS = [cases.case_id(c) for c in cases.CASES]
TEMP_RTOL = 0.005
FLOAT_TOL = 1e-5


@pytest.fixture(scope="module")
def traced():
    """The fake-world jobs, each in a spawned process, started before
    the ranks so that both run at once."""
    pool = concurrent.futures.ProcessPoolExecutor(
        max_workers=3 + len(cases.PRODUCTION_GROUPS),
        mp_context=multiprocessing.get_context("spawn"))
    jobs = {"records": pool.submit(cases.records, cases.CASES),
            "edges": pool.submit(cases.first_and_last, cases.EDGE_CELLS),
            "extrapolations": pool.submit(cases.extrapolations,
                                          cases.EXTRAPOLATION_CASES)}
    prod = [pool.submit(cases.production, g)
            for g in cases.PRODUCTION_GROUPS]
    yield jobs, prod
    pool.shutdown(cancel_futures=True)


@pytest.fixture(scope="module")
def ranks(traced):
    return run_ranks(cases.rank_cases, 4, cases.CASES)


@pytest.fixture(scope="module")
def records(traced):
    return traced[0]["records"].result(timeout=600)


@pytest.fixture(scope="module")
def production(traced):
    out = {}
    for job in traced[1]:
        out.update(job.result(timeout=600))
    return out


def _moe_on_model_axis(case) -> bool:
    return cases.config(case[0], case[4]).moe is not None and \
        case[2][1] > 1


def _mesh_groups(case):
    """The rank groups that each ran ``case`` on a mesh of their own."""
    return cases.PLACEMENT[case[2]]


# ------------------------------------------ the record against the ranks ----
@pytest.mark.parametrize("i", range(len(cases.CASES)), ids=CASE_IDS)
def test_collective_bytes_match_real_ranks(records, ranks, i):
    """The traced rank's collectives, by kind, equal what every real
    rank's step moved through ``repro_torch.dist``, exactly."""
    rec = records[i]
    assert rec["trace"]["per_rank"] is True
    assert rec["collective_bytes"]
    assert set(rec["collective_bytes"]) <= REFERENCE_KINDS
    for rank in range(4):
        assert ranks[rank][i]["collective_bytes"] == \
            rec["collective_bytes"], rank


@pytest.mark.parametrize("i", range(len(cases.CASES)), ids=CASE_IDS)
def test_argument_bytes_match_real_ranks(records, ranks, i):
    """The record's argument bytes (exact from the partition specs)
    equal every real rank's shards and rows."""
    for rank in range(4):
        assert ranks[rank][i]["argument_bytes"] == \
            records[i]["per_device"]["argument_bytes"], rank


@pytest.mark.parametrize("i", range(len(cases.CASES)), ids=CASE_IDS)
def test_temp_bytes_match_real_ranks(records, ranks, i):
    """The traced temp bytes within 0.5% of each real rank's (the MoE
    on a model axis: of the mean of a mesh's ranks, see the module
    docstring)."""
    want = records[i]["per_device"]["temp_bytes"]
    if _moe_on_model_axis(cases.CASES[i]):
        for group in _mesh_groups(cases.CASES[i]):
            real = [ranks[r][i]["temp_bytes"] for r in group]
            mean = sum(real) / len(real)
            assert abs(mean - want) <= TEMP_RTOL * want, (real, want)
        return
    for rank in range(4):
        real = ranks[rank][i]["temp_bytes"]
        assert abs(real - want) <= TEMP_RTOL * want, (rank, real, want)


@pytest.mark.parametrize("i", range(len(cases.CASES)), ids=CASE_IDS)
def test_flops_match_real_ranks(records, ranks, i):
    """The record's FLOPs (a microbatch's times the microbatches, plus
    the step's end) equal ``FlopCounterMode``'s count of every real
    rank's whole step, exactly (the MoE on a model axis: summed over a
    mesh's ranks)."""
    want = records[i]["flops"]
    if _moe_on_model_axis(cases.CASES[i]):
        for group in _mesh_groups(cases.CASES[i]):
            assert sum(ranks[r][i]["flops"] for r in group) == \
                want * len(group)
        return
    for rank in range(4):
        assert ranks[rank][i]["flops"] == want, rank


@pytest.mark.parametrize("i", [i for i, c in enumerate(cases.CASES)
                               if c[1] == "decode"],
                         ids=[c for c, k in zip(CASE_IDS, cases.CASES)
                              if k[1] == "decode"])
def test_sharded_decode_tokens_match_one_process(ranks, i):
    """The real sharded decode steps that the records are held against
    give one process's tokens on every rank."""
    for rank in range(4):
        got = ranks[rank][i]
        assert got["outputs"] == got["one"], rank


def test_kv_head_shared_by_two_ranks_decodes_as_one_process(ranks):
    """Two KV heads over four model ranks (each rank's query head maps
    to a KV head that another rank's shares, so the cache splits over
    the sequence and the ranks' new keys and values are gathered):
    prefill and greedy decode give one process's tokens, logits and
    caches."""
    for rank in range(4):
        got = ranks[rank][len(cases.CASES)]
        assert got["tokens_equal"], rank
        assert got["logits"] <= FLOAT_TOL and got["caches"] <= FLOAT_TOL, \
            got


# ----------------------------------------------------------- the trace ----
@pytest.mark.parametrize("cell", cases.EDGE_CELLS,
                         ids=[f"{a}-{s}" for a, s in cases.EDGE_CELLS])
def test_rank0_and_last_rank_count_the_same(traced, cell):
    """Rank 0 and rank 255 of 16 x 16 (full width, two units) count the
    same FLOPs, bytes accessed, collectives and temp bytes."""
    first, last = traced[0]["edges"].result(timeout=600)[
        cases.EDGE_CELLS.index(cell)]
    assert first["collective_bytes"]
    assert first == last


@pytest.mark.parametrize("i", range(len(cases.EXTRAPOLATION_CASES)),
                         ids=[f"{a}-{k}-{m}" for a, k, m in
                              cases.EXTRAPOLATION_CASES])
def test_extrapolation_matches_full_depth_on_a_rank(traced, i):
    """On rank 0 of (1, 2): counts extrapolated from 2 and 3 units
    (train's bytes accessed through 2, 3 and 4) to 5 equal the
    full-depth trace's, exactly: FLOPs, bytes accessed and collective
    bytes by kind, of the whole trace and of the step's end, and the
    peak of live bytes."""
    full, got, full_step, got_step, temp, got_temp = \
        traced[0]["extrapolations"].result(timeout=600)[i]
    assert full["collective_bytes"]
    assert got == full
    assert got_step == full_step
    assert got_temp == temp


@pytest.mark.parametrize("arch", [a for g in cases.PRODUCTION_GROUPS
                                  for a in g])
def test_production_records(production, arch):
    """Every architecture at full width (cut to two units) on 16 x 16
    and 2 x 16 x 16, at decode_32k and a train shape of the production
    batch: collectives under the reference's names only, some on every
    record (both meshes split the model and the data), and the rank's
    temp bytes at most the whole-width step's. whisper-small, whose 12
    heads do not split 16 ways, has six records (three shapes, two
    meshes), each rank 0's traced step like the others (its attention
    over every head on every rank): ``per_rank`` true, collectives
    counted, and the note that says its attention runs whole.

    One rank holds more temp than the whole-width step: recurrentgemma-9b
    decoding on 2 x 16 x 16. Its local attention's single KV head (256
    columns) splits 16 ways by the rules, so each rank gathers ``wk`` and
    ``wv`` whole (and copies each once to lay it out) in each local layer,
    while a whole-width step at that rank's 4 rows holds those weights as
    arguments. Its temp is held at most the whole width's plus those
    four copies."""
    recs = {k: v for k, v in production.items() if k[0] == arch}
    assert len(recs) == (6 if arch == "whisper-small" else 4)
    for key, rec in recs.items():
        assert rec["status"] == "ok", key
        trace, pd = rec["trace"], rec["per_device"]
        assert trace["per_rank"] is True, key
        assert rec["collective_bytes"], key
        assert set(rec["collective_bytes"]) <= REFERENCE_KINDS, key
        notes = [dryrun.NOTES]
        if arch == "whisper-small":
            notes.append(dryrun.HEADS_WHOLE_NOTE.format(12, 16))
        assert rec["notes"] == notes, key
        bound = trace["full_width_temp_bytes"]
        if key == ("recurrentgemma-9b", "decode_32k", "2x16x16"):
            bound += 4 * 4096 * 256 * 2
        assert pd["temp_bytes"] <= bound, key


# ------------------------------------------------------- the fake world ----
def test_fake_world_refuses_inside_a_running_group(ranks):
    """A process with a gloo group running cannot start a fake world:
    one process has one default group."""
    for rank in range(4):
        refused = ranks[rank][len(cases.CASES) + 1]
        assert refused and "already running" in refused, rank


def test_fake_world_needs_the_fake_backend(monkeypatch):
    """Without torch's fake backend the fake world raises, and so does a
    record on a mesh of two: no whole-width trace takes its place."""
    monkeypatch.setitem(
        sys.modules, "torch.testing._internal.distributed.fake_pg", None)
    with pytest.raises(RuntimeError, match="no fake process-group"):
        with dist.fake_world((1, 2)):
            pass
    with pytest.raises(RuntimeError, match="no fake process-group"):
        dryrun.cell_record(cases.config("qwen3-8b", {}),
                           cases.SHAPES["decode"],
                           abstract_mesh((1, 2), cases.NAMES))
    assert not dist.is_initialized()


def test_fake_backend_runs_the_port_collectives():
    """torch's private fake backend (``fake_pg``) still imports and
    completes the port's collectives for one rank of a larger world, on
    fake tensors with the shapes of a real run; ``StepTrace`` sees each
    as a ``c10d`` operator and counts the bytes that ``repro_torch.dist``
    counts."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.launch.mesh import mesh_over_ranks
    with dist.fake_world((2, 4), rank=5) as n:
        assert n == 8 and dist.rank() == 5 and dist.world_size() == 8
        mesh = mesh_over_ranks((2, 4), cases.NAMES)
        assert mesh.comm.coords == (1, 1)
        model = mesh.comm.axis(("model",))
        data = mesh.comm.axis(("data",))
        with FakeTensorMode():
            x = torch.empty((8, 6), dtype=torch.bfloat16)
            dist.reset_collective_bytes()
            with dryrun.StepTrace(x) as tr:
                assert tuple(dist.all_reduce(x.clone(), model.group).shape) \
                    == (8, 6)
                assert tuple(dist.all_gather(x, model.group, dim=1).shape) \
                    == (8, 24)
                assert tuple(dist.reduce_scatter(
                    x.float(), data.group, dim=0).shape) == (4, 6)
        assert dist.collective_bytes() == tr.collective_bytes == {
            "all-reduce": 96, "all-gather": 384, "reduce-scatter": 96}
    assert not dist.is_initialized()


def test_fake_backend_is_imported_only_in_dist():
    """torch's private ``fake_pg`` module is named in one file of the
    port, ``repro_torch/dist.py`` (``chip_smoke.py`` reaches it through
    the dry-run only)."""
    from pathlib import Path
    root = Path(__file__).resolve().parents[1]
    users = sorted(str(f.relative_to(root)) for f in
                   [*(root / "src" / "repro_torch").rglob("*.py"),
                    root / "chip_smoke.py"]
                   if "fake_pg" in f.read_text())
    assert users == ["src/repro_torch/dist.py"]


def _accessed(fn, *args) -> int:
    with dryrun.StepTrace(args) as tr:
        fn(*args)
    return tr.bytes_accessed


def test_bytes_accessed_counted_by_hand():
    """``StepTrace``'s bytes accessed against a count by hand: every
    operator's tensor inputs and outputs at numel x itemsize, views 0."""
    from repro_torch.models.layers import rms_norm
    x = torch.randn(8, 16)
    w = torch.randn(32, 16)
    # x @ w.T: a transpose (a view: 0), then mm reads x and w and writes
    # out
    assert _accessed(lambda a, b: a @ b.T, x, w) == 4 * (8 * 16 + 32 * 16
                                                         + 8 * 32)
    # rms_norm of bf16 x (8, 16) with w (16,): to float32, square, mean,
    # + eps, rsqrt, x * rsqrt (bf16 x float32 -> float32), to bf16, 1 + w,
    # the product (bf16 x bf16)
    xb, wb = x.bfloat16(), torch.randn(16).bfloat16()
    n, r = 8 * 16, 8
    want = ((2 * n + 4 * n) + (4 * n + 4 * n) + (4 * n + 4 * r)
            + (4 * r + 4 * r) + (4 * r + 4 * r) + (2 * n + 4 * r + 4 * n)
            + (4 * n + 2 * n) + (2 * 16 + 2 * 16) + (2 * n + 2 * 16 + 2 * n))
    assert _accessed(rms_norm, xb, wb) == want
    # views, a transpose, a slice, an expand and a detach: nothing moves
    assert _accessed(lambda a: a.view(4, 32).t()[1:].unsqueeze(0)
                     .expand(3, -1, -1).detach(), x) == 0
