"""Work counts, peaks and the trace readers against hand-computed
numbers."""
import json
from pathlib import Path

import pytest

from pimbench import trace, work
from pimbench.config import model_config
from smoke import smoke_spec

BENCH = Path(__file__).resolve().parents[1]


def _spec(name):
    return json.loads((BENCH / "configs" / f"{name}.json").read_text())


def test_deepseek_7b_ffn_up_at_64_rows():
    # x (64, 4096) @ w (4096, 11008) at 8 bits
    ops, nbytes = work.linear_work(64, 4096, 11008, 8)
    assert ops == 2 * 64 * 4096 * 11008 == 5_771_362_304
    assert nbytes == 45_088_768 + 1_048_576 + 2_818_048 + 44_032
    assert nbytes == 48_999_424
    # bytes-bound: 48,999,424 B at 3.35 TB/s is 14.63 us; the ops 2.92 us
    assert work.bound_s(ops, nbytes) == pytest.approx(48_999_424 / 3.35e12)
    assert ops / work.PEAK_OPS == pytest.approx(2.916302e-6, rel=1e-6)


def test_ragged_call_with_empty_experts():
    counts = [3, 0, 5, 0, 1]           # 9 rows, 3 experts read
    ops, nbytes = work.ragged_work(counts, 2048, 1408, 8)
    assert ops == 2 * 9 * 2048 * 1408 == 51_904_512
    assert nbytes == 3 * 2048 * 1408 + 4 * 9 * 2048 + 4 * 9 * 1408 + 4
    assert nbytes == 8_775_172
    assert work.ragged_work([0, 0], 8, 8, 8) == (0, 4)


def test_active_parameters_and_model_flops():
    dense = model_config(_spec("ds7b-pim"), "ds7b-pim")
    per_layer = 4 * 4096 * 4096 + 3 * 4096 * 11008
    assert work.active_params(dense) == 30 * per_layer + 4096 * 102400
    assert work.active_params(dense) == 6_490_685_440
    moe = model_config(_spec("dsmoe16b-pim"), "dsmoe16b-pim")
    attn = 4 * 2048 * 2048
    dense_layer = attn + 3 * 2048 * 10944
    moe_layer = attn + 2048 * 64 + (6 + 2) * 3 * 2048 * 1408
    assert work.active_params(moe) == (dense_layer + 15 * moe_layer
                                       + 2048 * 102400)
    # one token attending 10 positions, then 2 tokens attending 3 each
    f = work.model_flops(dense, 1, 10)
    assert f == 2 * 6_490_685_440 + 4 * 4096 * 30 * 10
    assert work.model_flops(dense, 2, 6) == 2 * f - 4 * 4096 * 30 * 14


def _ev(cat, name, ts, dur, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "tid": 1, "args": args}


def test_trace_reader_idle_share_launches_and_pim_time():
    events = [
        _ev("user_annotation", trace.WINDOW, 0.0, 100.0),
        _ev("user_annotation", trace.PIM, 5.0, 30.0),
        _ev("cpu_op", "aten::mm", 6.0, 4.0),
        _ev("cuda_runtime", "cudaLaunchKernel", 8.0, 1.0, correlation=1),
        _ev("cuda_runtime", "cudaLaunchKernel", 38.0, 1.0, correlation=2),
        _ev("cuda_runtime", "cudaMemcpyAsync", 52.0, 1.0, correlation=3),
        _ev("cpu_op", "aten::item", 50.0, 12.0),
        _ev("kernel", "gemm", 10.0, 20.0, correlation=1),
        _ev("kernel", "add", 40.0, 10.0, correlation=2),
        _ev("gpu_memcpy", "Memcpy DtoH", 60.0, 10.0, correlation=3),
        _ev("kernel", "outside", 120.0, 5.0, correlation=4),
    ]
    s = trace.summarize(events)
    assert s.window_s == pytest.approx(100e-6)
    assert s.busy_s == pytest.approx(40e-6)
    assert s.device_s == pytest.approx(40e-6)
    assert s.kernels == 2
    assert s.pim_call_s == [pytest.approx(20e-6)]
    assert s.device_ops[0] == ("gemm", pytest.approx(20e-6))
    # gaps: 30 us from 70 to 100, 10 from 0, 10 from 30, 10 from 50
    assert s.idle_gaps[0] == ("python", pytest.approx(30e-6))
    assert ("aten::item", pytest.approx(10e-6)) in s.idle_gaps
    assert 100 * (1 - s.busy_s / s.window_s) == pytest.approx(60.0)


def test_smoke_spec_keeps_the_config_keys():
    for name in ("ds7b-pim", "dsmoe16b-pim"):
        assert set(smoke_spec(name)) == set(_spec(name))


@pytest.mark.parametrize("name", ["ds7b-pim", "dsmoe16b-pim"])
def test_layout_cache_gives_the_layout_and_the_weights(name, tmp_path):
    """The parameter layout kept on disk reads back as the port's own:
    the same leaves, shapes and tree, and the same weights drawn."""
    import torch

    from pimbench.weights import _leaf_name, draw_weights, param_layout
    from repro_torch.models.model import abstract_params
    from repro_torch.tree import tree_flatten, tree_flatten_with_path
    cfg = model_config(smoke_spec(name), name)
    pairs, treedef = tree_flatten_with_path(abstract_params(cfg,
                                                            torch.float32))
    port = [(_leaf_name(p), tuple(x.shape)) for p, x in pairs]
    made = param_layout(cfg, cache_dir=tmp_path)
    assert len(list(tmp_path.iterdir())) == 1
    kept = param_layout(cfg, cache_dir=tmp_path)
    for flat, tree in (made, kept):
        assert flat == port
        assert repr(tree) == repr(treedef)
    a, _ = tree_flatten(draw_weights(cfg, 7, "cpu", layout=made))
    b, _ = tree_flatten(draw_weights(cfg, 7, "cpu", layout=kept))
    c, _ = tree_flatten(draw_weights(cfg, 7, "cpu"))
    assert all(torch.equal(x, y) and torch.equal(x, z)
               for x, y, z in zip(a, b, c))
