"""The port's multi-pod dry-run against the reference's rules.

The reference's own dry-run cannot run on this host (its jitted steps
raise jax's ``ShardingTypeError``; ``tests/test_dryrun_smoke.py``), and
XLA:CPU's FLOP count is no yardstick (``benchmarks/analytic.py``), so
the port is held against what does run here: the reference's production
meshes, input specs and partition rules (``jax.eval_shape`` and
``NamedSharding.shard_shape`` on an ``AbstractMesh``), its HLO parser,
and the repo's closed-form FLOP count. The trace itself is held against
a full-depth trace, against ``FlopCounterMode`` over a real CPU run and
against the live bytes of the same step on real CPU tensors.

Tolerances: argument and output bytes, input specs, meshes, collective
bytes, FLOPs (extrapolated against full depth, fake against real) and
the extrapolated peaks of live bytes (against the full-depth trace's,
phase by phase) are exact; decode FLOPs x model-axis x data-shards
within 1% of ``analytic_flops`` (the closed form leaves out small
products such as RWKV's decay LoRA: 0.12% of rwkv6-7b's step); the
traced temp bytes within 0.5% of a real CPU step's peak of live bytes
(the MoE's real routing against the trace's balanced one, a decode's
``position`` scalar: at most 0.1% at smoke size).
"""
import json
import os
import subprocess
import sys
import warnings
from pathlib import Path

import jax
import jax.numpy as jnp
import pytest

torch = pytest.importorskip("torch")

from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402
from torch.utils.flop_counter import FlopCounterMode  # noqa: E402

from benchmarks.analytic import analytic_flops  # noqa: E402
from repro.configs import SHAPES as JAX_SHAPES  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.launch import mesh as jmesh  # noqa: E402
from repro.models.model import build_model as jax_build  # noqa: E402
from repro.models.model import input_specs as jax_input_specs  # noqa: E402
from repro.optim import adamw as ja  # noqa: E402
from repro.train import sharding as jsh  # noqa: E402
from repro_torch.configs import ARCHS, SHAPES, ShapeSpec, get_config  # noqa: E402,E501
from repro_torch.configs.shapes import shape_applicable  # noqa: E402
from repro_torch.engine import Engine  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import (abstract_mesh,  # noqa: E402
                                     make_production_mesh)
from repro_torch.models import build_model, input_specs  # noqa: E402
from repro_torch.models.transformer import stack_plan  # noqa: E402
from repro_torch.optim import AdamWConfig, adamw_init  # noqa: E402
from repro_torch.train import (make_prefill, make_serve_step,  # noqa: E402
                               make_train_step)
from repro_torch.train.sharding import shard_shape  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
MESHES = [((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model"))]
MESH_IDS = ["16x16", "2x16x16"]


# ------------------------------------------------------------- meshes ----
@pytest.mark.parametrize("multi_pod", [False, True], ids=MESH_IDS)
def test_production_mesh_matches_reference(monkeypatch, multi_pod):
    """The reference's mesh (``jax.make_mesh`` patched to build an
    ``AbstractMesh``: this host has one device) has the port's names and
    sizes."""
    monkeypatch.setattr(jax, "make_mesh", lambda shape, axes:
                        jsh.abstract_mesh(tuple(shape), tuple(axes)))
    ref = jmesh.make_production_mesh(multi_pod=multi_pod)
    port = make_production_mesh(multi_pod=multi_pod)
    assert port.axis_names == tuple(ref.axis_names)
    assert port.shape == dict(ref.shape)
    assert port.devices is None


def test_shard_shape_raises_where_a_dimension_does_not_split():
    mesh = make_production_mesh()
    assert shard_shape(mesh, (32, 7), ("data", None)) == (2, 7)
    assert shard_shape(mesh, (32, 512), (None, ("data", "model"))) == \
        (32, 2)
    assert shard_shape(mesh, (3,), ()) == (3,)
    with pytest.raises(ValueError, match="does not split"):
        shard_shape(mesh, (8, 4), ("data", None))


# -------------------------------------------------------- input specs ----
def _cells():
    return [(a, s) for a in sorted(ARCHS) for s in SHAPES
            if shape_applicable(get_config(a), s)[0]]


def test_input_specs_match_reference():
    """All 32 cells: the same keys in the same order, shapes and dtypes,
    as ``device="meta"`` tensors."""
    cells = _cells()
    assert len(cells) == 32
    for arch, shape in cells:
        jshape = next(s for s in JAX_SHAPES if s.name == shape.name)
        ref = jax_input_specs(jax_config(arch), jshape)
        port = input_specs(get_config(arch), shape)
        assert list(port) == list(ref), (arch, shape.name)
        for k, v in port.items():
            assert v.device.type == "meta"
            assert tuple(v.shape) == tuple(ref[k].shape), (arch, k)
            assert str(v.dtype).removeprefix("torch.") == \
                str(ref[k].dtype), (arch, k)


# -------------------------------------------------- argument/out bytes ----
def _ref_bytes(tree, shardings) -> int:
    leaves = jax.tree.leaves(tree)
    shs = jax.tree.leaves(shardings)
    assert len(leaves) == len(shs)
    total = 0
    for x, sh in zip(leaves, shs):
        n = 1
        for d in sh.shard_shape(x.shape):
            n *= d
        total += n * jnp.dtype(x.dtype).itemsize
    return total


def _reference_record_bytes(model, params, shape_name, axes):
    """(argument, output) bytes on one device from the reference's own
    rules: its specs and shapes (``jax.eval_shape``; ``params`` is its
    bf16 parameters'), its shardings on an ``AbstractMesh`` and its
    steps' ``in_shardings``/``out_shardings`` (``repro.train.step``)."""
    from jax.sharding import NamedSharding, PartitionSpec as P
    mesh = jsh.abstract_mesh(*axes)
    cfg = model.cfg
    shape = next(s for s in JAX_SHAPES if s.name == shape_name)
    p = _ref_bytes(params, jsh.param_shardings(mesh, params))
    specs = jax_input_specs(cfg, shape)
    bs = jsh.batch_shardings(mesh, specs)
    batch = _ref_bytes(specs, bs)
    rep = NamedSharding(mesh, P())
    if shape.kind == "train":
        opt = jax.eval_shape(ja.adamw_init, params)
        zs = jsh.zero1_shardings(mesh, params)
        o = _ref_bytes(opt, ja.OptState(m=zs, v=zs, count=rep))
        _, _, metrics = jax.eval_shape(
            lambda g, s, q: ja.adamw_update(ja.AdamWConfig(), g, s, q),
            params, opt, params)
        metrics = dict(metrics, loss=jax.ShapeDtypeStruct((), jnp.float32))
        m = _ref_bytes(metrics, {k: rep for k in metrics})
        return p + o + batch, p + o + m
    key = "tokens" if shape.kind == "prefill" else "token"
    nxt = jax.ShapeDtypeStruct((shape.global_batch, 1), jnp.int32)
    out = _ref_bytes(nxt, bs[key])
    if shape.kind == "prefill":
        return p + batch, out
    states = jax.eval_shape(lambda: model.init_decode_state(
        shape.global_batch, shape.seq_len, jnp.bfloat16))
    s = _ref_bytes(states, jsh.state_shardings(mesh, states))
    return p + s + batch, s + out


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_spec_bytes_match_reference_rules(arch):
    """Every record of ``arch`` (each applicable shape on both meshes;
    64 records over the ten architectures): argument and output bytes
    equal, exactly, those of the reference's rules and shapes."""
    cfg = get_config(arch)
    params = dryrun.abstract_params(cfg)
    jmodel = jax_build(jax_config(arch))
    jparams = jax.eval_shape(lambda k: jmodel.init(k, jnp.bfloat16),
                             jax.random.PRNGKey(0))
    n = 0
    for shape in SHAPES:
        if not shape_applicable(cfg, shape)[0]:
            continue
        for axes in MESHES:
            want = _reference_record_bytes(jmodel, jparams, shape.name, axes)
            got = dryrun.spec_bytes(cfg, shape, abstract_mesh(*axes),
                                    params)
            assert got == want, (arch, shape.name, axes)
            n += 1
    assert n == 2 * (4 if cfg.is_subquadratic else 3)


# -------------------------------------------------- collective bytes ----
HLO_TEXTS = [
    "%ag = bf16[16,4096]{1,0} all-gather(bf16[1,4096]{1,0} %p), "
    "dimensions={0}\n"
    "%ar.1 = f32[128]{0} all-reduce(f32[128]{0} %x), to_apply=%add",
    "%t = (f32[8,8]{1,0}, bf16[4]{0}) all-reduce(f32[8,8]{1,0} %a, "
    "bf16[4]{0} %b), to_apply=%sum\n"
    "  %rs = s32[2,3]{1,0} reduce-scatter(s32[32,3]{1,0} %c), "
    "dimensions={0}",
    "%ags = (bf16[2,8]{1,0}, bf16[32,8]{1,0}) all-gather-start("
    "bf16[2,8]{1,0} %p)\n"
    "%agd = bf16[32,8]{1,0} all-gather-done(%ags)\n"
    "%cp = u8[64]{0} collective-permute-start(u8[64]{0} %q), "
    "source_target_pairs={{0,1}}\n"
    "%a2a = f8e4m3fn[4,4]{1,0} all-to-all(f8e4m3fn[4,4]{1,0} %r)",
    "%odd = c64[10]{0} all-reduce(c64[10]{0} %z), to_apply=%add\n"
    "%mix = (tok[], f32[3]{0}) all-reduce(f32[3]{0} %w)\n"
    "%none = f32[5]{0} add(f32[5]{0} %u, f32[5]{0} %v)\n"
    "not an instruction all-reduce(f32[9] %k)",
]

_REF_COLLECTIVES = r"""
import json, sys
from repro.launch.dryrun import collective_bytes
print(json.dumps([collective_bytes(t) for t in json.loads(sys.stdin.read())]))
"""


def test_collective_bytes_match_reference():
    """The HLO parser's sums on fixed texts (tuple results, ``-start``
    forms, unknown dtypes, lines that are no instruction) equal the
    reference's. The reference module sets ``XLA_FLAGS`` when imported,
    so it runs in a child process."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    env.pop("XLA_FLAGS", None)
    out = subprocess.run([sys.executable, "-c", _REF_COLLECTIVES],
                         input=json.dumps(HLO_TEXTS), env=env,
                         capture_output=True, text=True, timeout=120,
                         check=True).stdout
    want = json.loads(out.strip().splitlines()[-1])
    got = [dryrun.collective_bytes(t) for t in HLO_TEXTS]
    assert got == want
    assert got[1] == {"all-reduce": 264, "reduce-scatter": 24}
    assert "all-gather" in got[2] and "all-to-all" in got[2]


# -------------------------------------------------------- the trace ----
def _deep_smoke(arch: str, units: int = 5):
    """``arch``'s smoke config with ``units`` stacked units."""
    cfg = get_config(arch, smoke=True)
    prefix, unit, _, suffix = stack_plan(cfg.scaled(
        n_layers=cfg.n_layers * 4))
    cfg = cfg.scaled(n_layers=len(prefix) + units * len(unit) + len(suffix))
    assert stack_plan(cfg)[2] == units, arch
    return cfg


SMOKE_SHAPES = {"train": ShapeSpec("train_s", 32, 4, "train"),
                "prefill": ShapeSpec("prefill_s", 48, 2, "prefill"),
                "decode": ShapeSpec("decode_s", 40, 2, "decode")}


@pytest.mark.parametrize("arch,kind,microbatches", [
    ("qwen3-8b", "train", 1), ("gemma2-9b", "train", 2),
    ("deepseek-moe-16b", "train", 1), ("whisper-small", "train", 2),
    ("recurrentgemma-9b", "prefill", 1), ("rwkv6-7b", "prefill", 1),
    ("pixtral-12b", "prefill", 1), ("qwen3-8b", "flash", 1)])
def test_extrapolation_matches_full_depth(arch, kind, microbatches):
    """Traces at 2 and 3 stacked units, extrapolated to 5: FLOPs,
    bytes accessed (train's through 2, 3 and 4 units; as the whole trace
    and as the step's end), no collectives on one device, and the peak
    of live bytes (each phase's extrapolated, the largest taken) equal
    the full-depth trace's, exactly; ``flash`` is a prefill long enough
    for the blockwise attention. ``tests/test_torch_dryrun_sharded.py``
    does the same on a rank of (1, 2)."""
    cfg = _deep_smoke(arch)
    shape = (ShapeSpec("flash_s", 2560, 1, "prefill") if kind == "flash"
             else SMOKE_SHAPES[kind])
    rows = shape.global_batch
    full, two, three = (dryrun.trace_step(cfg, shape, rows, units=u,
                                          microbatches=microbatches)
                        for u in (None, 2, 3))
    assert two["flops"] < three["flops"] < full["flops"]
    assert dryrun._extrapolate(two["flops"], three["flops"], 5) == \
        full["flops"]
    temp = max(dryrun._extrapolate(a - two["args_bytes"],
                                   b - three["args_bytes"], 5)
               for a, b in zip(two["peaks"], three["peaks"]))
    assert temp == full["peak_bytes"] - full["args_bytes"]
    assert len(full["peaks"]) == len(two["peaks"]) == (
        4 + (microbatches > 1) if kind == "train" else 1)
    # train's bytes accessed grow with the square of the depth (each
    # unit's gradient is a select's backward over the whole stacked
    # leaf): the parabola through 2, 3 and 4 units
    four = (dryrun.trace_step(cfg, shape, rows, units=4,
                              microbatches=microbatches)
            if kind == "train" else None)
    for got, want in ((dryrun._counts_at(two, three, 5, four), full),
                      (dryrun._counts_at(two["step"], three["step"], 5,
                                         four and four["step"]),
                       full["step"])):
        assert got == {"flops": want["flops"],
                       "bytes_accessed": want["bytes_accessed"],
                       "collective_bytes": want["collective_bytes"]}
    assert two["bytes_accessed"] < three["bytes_accessed"] < \
        full["bytes_accessed"]
    assert full["collective_bytes"] == {}


def _real_step(cfg, kind, shape, seed=0):
    """The step of ``kind`` on real CPU tensors at ``shape``, under
    FlopCounterMode; returns its count."""
    gen = torch.Generator().manual_seed(seed)
    model = build_model(cfg, remat=kind == "train",
                        engine=Engine("torch:device=cpu"))
    params = model.init(seed, torch.bfloat16)
    b, s = shape.global_batch, shape.seq_len
    batch = {k: (torch.randint(0, cfg.vocab_size, (b, *v.shape[1:]),
                               generator=gen, dtype=torch.int32)
                 if v.dtype == torch.int32 else
                 torch.randn((b, *v.shape[1:]), generator=gen
                             ).to(v.dtype))
             for k, v in input_specs(cfg, shape).items()}
    with FlopCounterMode(display=False) as fc:
        if kind == "train":
            for x in tree_leaves(params):
                x.requires_grad_()
            step, _, _ = make_train_step(model, AdamWConfig())
            step(params, adamw_init(params), None, batch)
        elif kind == "prefill":
            make_prefill(model)[0](params, batch)
        else:
            states = model.init_decode_state(b, s, torch.bfloat16)
            make_serve_step(model)[0](params, states, batch["token"],
                                      torch.zeros_like(batch["position"]))
    return fc.get_total_flops()


@pytest.mark.parametrize("arch", ["qwen3-8b", "deepseek-moe-16b",
                                  "recurrentgemma-9b", "rwkv6-7b"])
@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_fake_flops_match_real_run(arch, kind):
    """The fake trace's FLOPs equal ``FlopCounterMode``'s over the same
    step on real CPU tensors, exactly; for the MoE the real routing is
    data-dependent, but dropless dispatch computes every routed pair, so
    the trace's balanced routing gives the same count."""
    cfg = get_config(arch, smoke=True)
    shape = SMOKE_SHAPES[kind]
    traced = dryrun.trace_step(cfg, shape, shape.global_batch)
    assert traced["flops"] == _real_step(cfg, kind, shape)


def _real_live_bytes(cfg, kind, shape, microbatches):
    """Two real steps of ``kind`` on CPU tensors at ``shape``, each under
    :class:`dryrun.StepTrace` from what it takes: each step's peak of
    live bytes above its arguments, and what it left alive."""
    gen = torch.Generator().manual_seed(0)
    model = build_model(cfg, remat=kind == "train",
                        engine=Engine("torch:device=cpu"))
    batch = {k: (torch.randint(0, cfg.vocab_size, tuple(v.shape),
                               generator=gen, dtype=v.dtype)
                 if v.dtype == torch.int32 else
                 torch.randn(tuple(v.shape), generator=gen).to(v.dtype))
             for k, v in input_specs(cfg, shape).items()}
    params = model.init(0, torch.bfloat16)
    temps, left = [], []
    if kind == "train":
        for x in tree_leaves(params):
            x.requires_grad_()
        step, _, _ = make_train_step(model, AdamWConfig(),
                                     microbatches=microbatches)
        state = [params, adamw_init(params)]

        def run(tr):
            state[0], state[1], _, _ = step(*state, None, batch)
        args = lambda: (state, batch)   # noqa: E731
    elif kind == "prefill":
        prefill, _ = make_prefill(model)

        def run(tr):
            prefill(params, batch)
        args = lambda: (params, batch)   # noqa: E731
    else:
        serve, _ = make_serve_step(model)
        state = [model.init_decode_state(shape.global_batch, shape.seq_len,
                                         torch.bfloat16), batch["token"]]

        def run(tr):
            state[1], state[0] = serve(params, state[0], state[1],
                                       batch["position"])
        args = lambda: (params, state, batch)   # noqa: E731
    for _ in range(2):
        with dryrun.StepTrace(args()) as tr:
            run(tr)
            tr.mark()
        temps.append(max(tr.peaks) - tr.args_bytes)
        left.append(tr.live - tr.args_bytes)
    return temps, left


@pytest.mark.parametrize("arch,kind,microbatches", [
    ("qwen3-8b", "train", 2), ("deepseek-moe-16b", "train", 2),
    ("gemma2-9b", "train", 1), ("whisper-small", "train", 2),
    ("rwkv6-7b", "decode", 1), ("recurrentgemma-9b", "prefill", 1)])
def test_trace_temp_matches_real_cpu_step(arch, kind, microbatches):
    """The fake trace's temp bytes against the live bytes of the same
    step on real CPU tensors, twice in a row: within 0.5% (the MoE's
    real routing is data-dependent, the trace's balanced: 0.1% at smoke
    size), and each real step leaves less than 0.5% of that behind (a
    train step's gradients held through the next microbatch's backward
    read 20% high; gradients held by a reference cycle into the next
    step left 40%)."""
    cfg = get_config(arch, smoke=True)
    shape = SMOKE_SHAPES[kind]
    rows = shape.global_batch // microbatches
    traced = dryrun.trace_step(cfg, shape, rows, microbatches=microbatches)
    temp = traced["peak_bytes"] - traced["args_bytes"]
    temps, left = _real_live_bytes(cfg, kind, shape, microbatches)
    for real, rest in zip(temps, left):
        assert abs(real - temp) <= 0.005 * temp, (temps, temp)
        assert rest <= 0.005 * temp, (left, temp)


def test_fake_decode_step_warns_nothing():
    """A decode step over fake tensors (stacked caches written in place)
    raises no warning: ``_put`` recognises a cache's slot without a data
    pointer."""
    cfg = get_config("qwen3-8b", smoke=True)
    model = build_model(cfg, engine=Engine("torch:device=cpu"))
    with FakeTensorMode(), warnings.catch_warnings():
        warnings.simplefilter("error")
        params = model.init(0, torch.bfloat16)
        states = model.init_decode_state(2, 16, torch.bfloat16)
        tok = torch.zeros((2, 1), dtype=torch.int32)
        logits, out = model.decode_step(params, tok, tok, states)
        assert out["scan"][0]["self"]["k"] is states["scan"][0]["self"]["k"]
    assert tuple(logits.shape) == (2, 1, cfg.vocab_size)


class _SlotCopies(TorchDispatchMode):
    """Counts ``aten.copy_`` into a slot (unit ``i``) of a stacked leaf,
    and those of them whose source is that slot itself."""

    def __init__(self, stacked):
        super().__init__()
        self.slots = {x[i].data_ptr(): tuple(x.shape[1:])
                      for x in tree_leaves(stacked) if x.numel()
                      for i in range(x.shape[0])}
        self.copies = self.self_copies = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten.copy_.default:
            dst, src = args[0], args[1]
            if self.slots.get(dst.data_ptr()) == tuple(dst.shape):
                self.copies += 1
                self.self_copies += (src.data_ptr() == dst.data_ptr()
                                     and src.stride() == dst.stride())
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("arch", ["qwen3-8b", "gemma2-9b", "rwkv6-7b"])
def test_decode_step_copies_no_cache_onto_itself(arch):
    """On real tensors (smoke width, three stacked units), a decode step
    writes the stacked caches in place and ``_put`` leaves every slot that the block already wrote alone:
    no ``copy_`` of a slot onto itself. A state that a block returns
    anew (RWKV's recurrent state) is still copied into its slot."""
    cfg = _deep_smoke(arch, units=3)
    model = build_model(cfg, engine=Engine("torch:device=cpu"))
    params = model.init(0, torch.float32)
    states = model.init_decode_state(2, 16, torch.float32)
    stacked = states["scan"]
    tok = torch.zeros((2, 1), dtype=torch.int32)
    for step in range(2):
        with _SlotCopies(stacked) as mode:
            _, out = model.decode_step(params, tok, tok + step, states)
        assert mode.self_copies == 0, (arch, step, mode.copies)
        assert all(a is b for a, b in zip(tree_leaves(out["scan"]),
                                          tree_leaves(stacked)))
        if cfg.family == "rwkv":
            assert mode.copies > 0


# ------------------------------------------------ full configs, cells ----
DECODE_CELLS = [(a, s.name) for a, s in _cells() if s.kind == "decode"]


@pytest.mark.parametrize("arch,shape_name", DECODE_CELLS)
def test_decode_flops_match_analytic(arch, shape_name):
    """The decode cells at full config on 16 x 16: the whole-width
    step's FLOPs (``trace.full_width_flops``, one device's rows) x the
    ways the batch splits over the data axes (1 where it is replicated,
    as ``long_500k``'s single sequence is) within 1% of
    ``benchmarks.analytic.analytic_flops``. For whisper the closed form
    also needs what its decoder does each step in both packages: the
    cross-attention keys, values and scores over all the encoder's
    frames. The record's ``flops`` is rank 0's own count: at least its
    share of the whole width over the 16-way model axis (what the ranks
    compute twice, such as a KV head that two ranks' query heads share,
    and the MoE's balanced routing, whose remainder goes to rank 0's
    experts, come on top; whisper-small's 12 heads do not split 16 ways,
    so its rank runs the attention whole)."""
    rec = dryrun.lower_cell(arch, shape_name, verbose=False)
    assert rec["status"] == "ok" and rec["trace"]["units"] == "all"
    cfg = get_config(arch)
    shape = next(s for s in SHAPES if s.name == shape_name)
    ways = shape.global_batch // rec["trace"]["rows"]
    want = analytic_flops(jax_config(arch), shape)
    if cfg.family == "encdec":
        b, f = shape.global_batch, cfg.enc_frames
        want += cfg.n_layers * 4 * b * f * (cfg.d_model * cfg.kv_dim
                                            + cfg.q_dim)
    whole = rec["trace"]["full_width_flops"]
    ratio = whole * ways / want
    assert 0.99 <= ratio <= 1.01, ratio
    assert rec["trace"]["per_rank"] is True
    assert rec["flops"] * 16 >= whole


def test_moe_cell_traces():
    """A MoE cell traces rank 0's sharded step under the fake trace's
    balanced routing: deepseek-moe-16b x decode_32k at full config on the
    multi-pod mesh (4 rows a device, 64 experts over 16 model ranks,
    top-6), with the counts of the reference's keys."""
    rec = dryrun.lower_cell("deepseek-moe-16b", "decode_32k",
                            multi_pod=True, verbose=False)
    assert rec["status"] == "ok" and rec["mesh"] == "2x16x16"
    assert rec["trace"]["rows"] == 4 and rec["flops"] > 0
    assert rec["trace"]["per_rank"] is True
    assert rec["compile_s"] is None and rec["bytes_accessed"] > 0
    assert rec["collective_bytes"] and set(rec["collective_bytes"]) <= {
        "all-reduce", "all-gather", "reduce-scatter", "all-to-all",
        "collective-permute"}
    assert rec["notes"] == [dryrun.NOTES]


def test_train_record_with_more_microbatches_than_rows():
    """A MoE train record at smoke width on the multi-pod mesh: 256 rows
    over 32 data-parallel devices are 8 a device, fewer than its 16
    microbatches, so it runs 8 microbatches of one row; the whole-width
    FLOPs are the one-row trace's x 8, the whole-width temp bytes the
    traced peak's (extrapolated from 2 and 3 units), which holds the
    float32 accumulator. The record itself is rank 0's (its four smoke
    heads, which do not split 16 ways, run whole on every rank)."""
    cfg = _deep_smoke("phi3.5-moe-42b-a6.6b")
    shape = ShapeSpec("train_s", 32, 256, "train")
    rec = dryrun.cell_record(cfg, shape, make_production_mesh(
        multi_pod=True), microbatches=16)
    assert rec["trace"]["per_rank"] is True
    assert rec["trace"] == {**rec["trace"], "rows": 1, "microbatches": 8,
                            "units": [2, 3, 4], "n_units": 5}
    full = dryrun.trace_step(cfg, shape, 1, microbatches=8)
    assert rec["trace"]["full_width_flops"] == full["flops"] * 8
    assert rec["trace"]["full_width_temp_bytes"] == \
        full["peak_bytes"] - full["args_bytes"]
    assert rec["notes"] == [dryrun.NOTES,
                            dryrun.HEADS_WHOLE_NOTE.format(4, 16)]
    one = dryrun.trace_step(cfg, shape, 1)    # no accumulator
    n_params = sum(x.numel() for x in tree_leaves(
        dryrun.abstract_params(cfg)))
    assert full["peaks"][0] - one["peaks"][0] == 4 * n_params


def test_cli_on_the_host(tmp_path):
    """``--device cpu``: rwkv6-7b x long_500k, exit 0, status ok, the
    record held against the stated H100 capacity."""
    out = tmp_path / "cell.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "rwkv6-7b", "--shape", "long_500k", "--device", "cpu",
         "--out", str(out)], env=env, capture_output=True, text=True,
        timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    rec = json.loads(out.read_text())[0]
    assert rec["status"] == "ok" and rec["mesh"] == "16x16"
    assert rec["card"]["memory_bytes"] == dryrun.H100_MEMORY_BYTES
    assert rec["card"]["fits"] is True
    assert "NVIDIA H100 80GB HBM3" in r.stdout


def test_cli_needs_cuda_by_default():
    """Without ``--device`` the dry-run holds cells against the card's
    memory: with no CUDA it raises before tracing anything."""
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="CUDA"):
        dryrun.main(["--arch", "rwkv6-7b", "--shape", "long_500k",
                     "--out", os.devnull])
