"""The readers of the program's own spans (``weight_share``,
``product_share``, ``weight_gib_per_step``) on synthetic tracer events:
only phases under the cell's step span count, through any depth of
parents; no device time gives None; steps with no phase under them give
0; bytes are divided by the steps."""
from types import SimpleNamespace

import pytest

import run as bench_run
from repro_torch import obs

GIB = 2 ** 30


def _span(sid, name, parent=None, **args):
    return {"name": name, "cat": "repro", "ph": "X", "ts": 0.0, "dur": 1.0,
            "pid": 1, "tid": 1, "id": sid, "parent": parent, "args": args}


def _decode_step(first, device=True):
    """One model.decode_step (1000 us) over two projections, each with a
    weight phase (300 us, 2 GiB) and a product (50 us), and, nested one
    level deeper, a block span between the step and the second one."""
    t = (lambda us: {"device_us": us}) if device else (lambda us: {})
    s, b, p1, p2 = first, first + 1, first + 2, first + 3
    return [
        _span(s, "model.decode_step", None, batch=4, **t(1000.0)),
        _span(p1, "pim.linear", s, **t(400.0)),
        _span(first + 4, "pim.weight", p1, bytes=2 * GIB, **t(300.0)),
        _span(first + 5, "pim.product", p1, **t(50.0)),
        _span(b, "block", s),
        _span(p2, "pim.linear", b, **t(400.0)),
        _span(first + 6, "pim.weight", p2, bytes=2 * GIB, **t(300.0)),
        _span(first + 7, "pim.product", p2, **t(50.0)),
    ]


def _forward(first):
    """A model.forward whose one projection is all weight work, and a
    pim.weight span outside any step (neither counts in a decode cell)."""
    return [_span(first, "model.forward", None, device_us=500.0),
            _span(first + 1, "pim.weight", first, bytes=7 * GIB,
                  device_us=500.0),
            _span(first + 2, "pim.weight", None, bytes=GIB, device_us=9.0)]


@pytest.fixture()
def events():
    """Load events into the process tracer; empty it after."""
    def load(evs):
        obs.reset_trace()
        obs.add_events(evs)
    yield load
    obs.reset_trace()


def _read(name, unit):
    run = SimpleNamespace(traffic={"window_unit": unit})
    return bench_run.reader(name)(run)


def test_decode_shares_count_nested_phases_under_decode_steps(events):
    events(_decode_step(1) + _decode_step(11) + _forward(21))
    # two steps of 1000 us, four weight phases of 300 us, four products
    assert _read("weight_share.decode", "step") == pytest.approx(60.0)
    assert _read("product_share.decode", "step") == pytest.approx(10.0)


def test_prefill_shares_read_model_forward(events):
    events(_decode_step(1) + _forward(21))
    assert _read("weight_share.prefill", "job") == pytest.approx(100.0)
    assert _read("product_share.prefill", "job") == 0.0


def test_steps_without_phases_read_zero(events):
    """Steps whose projections hold no weight work (each weight
    quantized once, outside the step) read 0, not None."""
    events([_span(1, "model.decode_step", None, device_us=800.0),
            _span(2, "pim.linear", 1, device_us=400.0),
            _span(3, "pim.product", 2, device_us=50.0),
            _span(4, "pim.weight", None, bytes=GIB, device_us=9.0)])
    assert _read("weight_share.decode", "step") == 0.0
    assert _read("weight_gib_per_step.decode", "step") == 0.0
    assert _read("product_share.decode", "step") == pytest.approx(6.25)


def test_weight_bytes_divided_by_steps(events):
    events(_decode_step(1) + _decode_step(11) + _decode_step(31)
           + _forward(21))
    # 3 steps x 2 projections x 2 GiB; the forward's 7 GiB and the
    # stray 1 GiB do not count
    assert _read("weight_gib_per_step.decode", "step") == pytest.approx(4.0)


def test_without_device_time_the_shares_read_none(events):
    events(_decode_step(1, device=False))
    assert _read("weight_share.decode", "step") is None
    assert _read("product_share.decode", "step") is None
    assert _read("weight_gib_per_step.decode", "step") == pytest.approx(4.0)


def test_without_spans_every_reader_reads_none(events):
    events([{"name": "occupancy", "ph": "C", "ts": 0.0, "pid": 2,
             "args": {"ops": 3}},
            {"name": "old", "ph": "X", "ts": 0.0, "dur": 1.0, "pid": 1,
             "tid": 1, "args": {"bytes": 4}}])
    for name in ("weight_share.decode", "product_share.decode",
                 "weight_gib_per_step.decode"):
        assert _read(name, "step") is None
    for name in ("weight_share.prefill", "product_share.prefill"):
        assert _read(name, "job") is None
