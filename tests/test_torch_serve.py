"""repro_torch.serve and the traffic launcher against the JAX package's
repro.serve: the same seeded traces, identical tokens, passes and steps
in every scheduling mode, and the port's versions of tests/test_serve.py
on the torch backend (``torch:device=cpu`` runs the kernels' plain
versions on the host)."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.engine import Engine as JaxEngine  # noqa: E402
from repro.pim import plan_serve_slots as jax_plan_serve_slots  # noqa: E402
from repro.device import DeviceConfig as JaxDeviceConfig  # noqa: E402
from repro.serve import TrafficConfig as JaxTrafficConfig  # noqa: E402
from repro.serve import generate as jax_generate  # noqa: E402
from repro.serve import reference_tokens as jax_reference_tokens  # noqa: E402
from repro.serve import run_load as jax_run_load  # noqa: E402
from repro_torch.device import DeviceConfig  # noqa: E402
from repro_torch.engine import Engine  # noqa: E402
from repro_torch.launch import serve as launcher  # noqa: E402
from repro_torch.pim import plan_serve_slots  # noqa: E402
from repro_torch.serve import (AdmissionController,  # noqa: E402
                               ContinuousBatcher, Request, RequestQueue,
                               TrafficConfig, compare_modes, generate,
                               reference_tokens, run_load)

pytestmark = pytest.mark.system

N_BITS = 8
PORT = "torch:device=cpu,pack=true"


def _req(rid, n_tokens, prompt=(3, 5), seed=0):
    return Request(rid=rid, arrival=0.0, prompt=tuple(prompt),
                   max_new_tokens=n_tokens, seed=seed)


def _trace(reqs):
    return [(r.rid, r.arrival, r.prompt, r.max_new_tokens, r.seed)
            for r in reqs]


# ------------------------------------------------ parity with repro ----
@pytest.mark.parametrize("cfg", [
    dict(n_requests=32, rate=500.0, seed=0, n_bits=8),
    dict(n_requests=20, rate=50.0, seed=7, n_bits=16),
    dict(n_requests=9, rate=1e6, seed=3, n_bits=4,
         prompt_lens=(1, 3), output_lens=(2, 5))])
def test_generate_and_reference_tokens_match_reference(cfg):
    """generate gives the reference's requests for the same config, and
    reference_tokens the reference's tokens (test_serve.py:23)."""
    mine, ref = generate(TrafficConfig(**cfg)), \
        jax_generate(JaxTrafficConfig(**cfg))
    assert _trace(mine) == _trace(ref)
    for elems in (2, 4):
        for a, b in zip(mine, ref):
            assert reference_tokens(a, cfg["n_bits"], elems) \
                == jax_reference_tokens(b, cfg["n_bits"], elems)


@pytest.mark.parametrize("mode", ["continuous", "roundtrip", "serial"])
def test_run_load_matches_reference(mode):
    """The same seeded trace through the reference's run_load on
    numpy:pack=true and the port's on torch (CPU): identical tokens per
    request, equal passes and steps, zero recompiles."""
    cfg = dict(n_requests=14, rate=500.0, seed=0, n_bits=N_BITS)
    ref = jax_run_load(JaxEngine("numpy:pack=true"),
                       jax_generate(JaxTrafficConfig(**cfg)), mode=mode,
                       realtime=False)
    eng = Engine(PORT)
    mine = run_load(eng, generate(TrafficConfig(**cfg)), mode=mode,
                    realtime=False)
    assert mine.bit_exact and ref.bit_exact
    assert mine.passes == ref.passes and mine.steps == ref.steps
    assert mine.n_tokens == ref.n_tokens and mine.n_requests == 14
    assert mine.recompiles == 0 == ref.recompiles
    # run_load returns no requests; replay one batcher to compare tokens
    # per request against the reference's plain-int tokens.
    b = ContinuousBatcher(eng, n_bits=N_BITS, resident=mode == "continuous",
                          **({"max_slots": 1, "ladder": (1,)}
                             if mode == "serial" else {}))
    for r in generate(TrafficConfig(**cfg)):
        b.queue.submit(r, 0.0)
    b.warmup()
    b.run_until_idle()
    refs = {r.rid: r for r in jax_generate(JaxTrafficConfig(**cfg))}
    assert len(b.finished_reqs) == 14
    for r in b.finished_reqs:
        assert r.tokens == jax_reference_tokens(refs[r.rid], N_BITS)


def test_serve_slot_plan_matches_reference():
    """plan_serve_slots gives the reference's budget and ladder, alone
    and scaled by a device hierarchy (2x4x16x8: 1,024 crossbars, 8 lanes
    each at n = 8)."""
    eng, ref_eng = Engine(PORT), JaxEngine("numpy:pack=true")
    for spec in (None, "2x4x16x8", "1x1x1x2"):
        dev = DeviceConfig.parse(spec) if spec else None
        ref_dev = JaxDeviceConfig.parse(spec) if spec else None
        mine = plan_serve_slots(eng, N_BITS, device=dev)
        ref = jax_plan_serve_slots(ref_eng, N_BITS, device=ref_dev)
        assert dataclasses.astuple(mine) == dataclasses.astuple(ref)
    assert plan_serve_slots(eng, N_BITS, device=DeviceConfig.parse(
        "2x4x16x8")).max_slots == 8192


# ---------------------------------------------------------- traffic ----
def test_traffic_deterministic_and_bounded():
    cfg = TrafficConfig(n_requests=10, rate=500.0, seed=7, n_bits=N_BITS)
    a, b = generate(cfg), generate(cfg)
    assert _trace(a) == _trace(b)
    assert generate(TrafficConfig(n_requests=10, seed=8))[0].arrival \
        != a[0].arrival
    hi = 1 << (N_BITS - 2)
    for r in a:
        assert r.arrival > 0
        assert len(r.prompt) in cfg.prompt_lens
        assert r.max_new_tokens in cfg.output_lens
        assert all(0 <= p < hi for p in r.prompt)
    assert all(x.arrival < y.arrival for x, y in zip(a, a[1:]))


def test_traffic_replay_via_fresh():
    r = generate(TrafficConfig(n_requests=1))[0]
    r.tokens.append(42)
    r.phase = "finished"
    r.t_submit = 1.0
    f = r.fresh()
    assert (f.rid, f.prompt, f.max_new_tokens) \
        == (r.rid, r.prompt, r.max_new_tokens)
    assert f.tokens == [] and f.phase == "queued" and f.t_submit is None
    assert r.tokens == [42]


# -------------------------------------------------------- admission ----
def test_queue_fcfs_and_prefill_admission():
    q = RequestQueue()
    for i in range(5):
        q.submit(_req(i, 1), now=float(i))
    adm = AdmissionController(q, max_live=2, priority="prefill")
    assert adm.admissible(live=0) == 2
    first = adm.admit(live=0, now=9.0)
    assert [r.rid for r in first] == [0, 1]
    assert all(r.t_admit == 9.0 for r in first)
    assert adm.admissible(live=1) == 1
    assert [r.rid for r in adm.admit(live=1)] == [2]
    assert adm.admissible(live=2) == 0
    assert len(q) == 2


def test_decode_priority_drains_batch_before_admitting():
    q = RequestQueue()
    for i in range(4):
        q.submit(_req(i, 1))
    adm = AdmissionController(q, max_live=2, priority="decode")
    assert len(adm.admit(live=0)) == 2
    assert adm.admissible(live=1) == 0
    assert adm.admissible(live=2) == 0
    assert len(adm.admit(live=0)) == 2


def test_admission_rejects_bad_config():
    q = RequestQueue()
    with pytest.raises(ValueError):
        AdmissionController(q, max_live=0)
    with pytest.raises(ValueError):
        AdmissionController(q, max_live=1, priority="fifo")


# ------------------------------------------------------- bit parity ----
def test_single_request_matches_reference():
    """test_serve.py:89 on the torch backend."""
    eng = Engine(PORT)
    req = _req(0, 3, prompt=(9, 17, 33))
    b = ContinuousBatcher(eng, n_bits=N_BITS, max_slots=1, ladder=(1,))
    b.warmup()
    b.queue.submit(req, 0.0)
    b.run_until_idle()
    assert req.phase == "finished"
    assert req.tokens == reference_tokens(req, N_BITS)
    assert len(req.tokens) == 3


@pytest.mark.parametrize("backend", ["numpy", "numpy:pack=true", PORT,
                                     "torch:device=cpu,pack=false"])
def test_eviction_backfill_bit_parity(backend):
    """test_serve.py:103: a sequence's tokens are identical whether it
    ran alone, joined mid-batch, or survived its neighbors' eviction —
    on the port's numpy and torch backends (``pack=false`` takes the
    round-trip path: no resident chain without packing)."""
    eng = Engine(PORT)
    reqs = [_req(0, 4), _req(1, 1, prompt=(7, 2, 11)),
            _req(2, 2, prompt=(5,)), _req(3, 1, prompt=(8, 8))]
    b = ContinuousBatcher(eng, n_bits=N_BITS, max_slots=2,
                          decode_elems=2, backend=backend)
    assert b.resident == (backend != "torch:device=cpu,pack=false")
    for r in reqs:
        b.queue.submit(r, 0.0)
    b.warmup()
    b.run_until_idle()
    for r in reqs:
        assert r.phase == "finished"
        assert r.tokens == reference_tokens(r, N_BITS, 2), \
            f"rid {r.rid} diverged under continuous batching"
    solo = reqs[0].fresh()
    sb = ContinuousBatcher(eng, n_bits=N_BITS, max_slots=1, ladder=(1,),
                           decode_elems=2, backend=backend)
    sb.queue.submit(solo, 0.0)
    sb.warmup()
    sb.run_until_idle()
    assert solo.tokens == reqs[0].tokens


# -------------------------------------------------------- dynamic K ----
def test_dynamic_k_tracks_live_batch_with_zero_recompiles():
    """test_serve.py:133 on the torch backend."""
    eng = Engine(PORT)
    b = ContinuousBatcher(eng, n_bits=N_BITS, max_slots=8,
                          decode_elems=2, resident=False)
    assert b.ladder == (1, 2, 4, 8)
    for i in range(8):
        b.queue.submit(_req(i, 1 + i % 3, prompt=(2 + i,)), 0.0)
    b.warmup()
    compiles0 = eng.stats()["compiles"]
    seen_k = []
    while not b.idle:
        st = b.step()
        seen_k.append((st.live, st.k))
        assert st.k == min(k for k in b.ladder if k >= st.live)
    assert seen_k[0] == (8, 8)
    assert any(k < 8 for _, k in seen_k)
    assert eng.stats()["compiles"] == compiles0
    assert len(b.finished_reqs) == 8
    for r in b.finished_reqs:
        assert r.tokens == reference_tokens(r, N_BITS, 2)


def test_pinned_ladder_caps_slots():
    """test_serve.py:158 on the torch backend."""
    eng = Engine(PORT)
    b = ContinuousBatcher(eng, n_bits=N_BITS, ladder=(4,), max_slots=4,
                          resident=False)
    assert b.ladder == (4,)
    for i in range(6):
        b.queue.submit(_req(i, 1), 0.0)
    b.warmup()
    st = b.step()
    assert st.live == 4 and st.k == 4


def test_device_scaled_budget_drains_one_pass_per_crossbar():
    """A budget above the top rung (max_slots 16 over a ladder topping
    at 8) serves round-trip as one pass per crossbar and resident as 16
    lanes; both bit-exact."""
    eng = Engine(PORT)
    reqs = generate(TrafficConfig(n_requests=20, rate=1e6, seed=5,
                                  n_bits=N_BITS))
    for resident in (False, True):
        b = ContinuousBatcher(eng, n_bits=N_BITS, max_slots=16,
                              resident=resident)
        for r in reqs:
            b.queue.submit(r.fresh(), 0.0)
        b.warmup()
        st = b.step()
        assert st.live == 16
        assert b.passes == (2 if not resident else 1)
        b.run_until_idle()
        assert all(r.tokens == reference_tokens(r, N_BITS)
                   for r in b.finished_reqs)
        assert len(b.finished_reqs) == 20


# ---------------------------------------------------------- harness ----
def test_harness_continuous_vs_serial_same_tokens_fewer_passes():
    """test_serve.py:171 on the torch backend."""
    eng = Engine(PORT)
    reqs = generate(TrafficConfig(n_requests=12, rate=1e6, seed=3,
                                  n_bits=N_BITS))
    res = compare_modes(eng, reqs, realtime=False)
    cont, ser = res["continuous"], res["serial"]
    assert res["tokens_match"] and cont.bit_exact and ser.bit_exact
    assert cont.n_tokens == ser.n_tokens > 0
    assert cont.recompiles == 0 and ser.recompiles == 0
    assert ser.passes >= 3 * cont.passes
    assert res["speedup"] > 1.0


def test_run_load_reports_slos():
    """test_serve.py:188 on the torch backend."""
    eng = Engine(PORT)
    reqs = generate(TrafficConfig(n_requests=6, rate=1e6, seed=1))
    rep = run_load(eng, reqs, realtime=False)
    assert rep.n_requests == 6
    s = rep.summary()
    assert s["tokens_per_s"] > 0
    assert s["ttft_p99_us"] >= s["ttft_p50_us"] > 0
    assert s["token_p99_us"] >= s["token_p50_us"] > 0
    assert rep.steps == rep.passes


def test_run_load_rejects_unknown_mode():
    """test_serve.py:200."""
    with pytest.raises(ValueError):
        run_load(Engine(PORT), [], mode="batch")


# --------------------------------------------------------- launcher ----
def _main(*argv):
    launcher.main(["--pim-backend", PORT, *argv])


def test_launcher_traffic_compare_passes():
    _main("--traffic", "8", "--traffic-compare", "--traffic-check", "1.0")


def test_launcher_fault_check_passes():
    _main("--traffic", "8", "--fault-rate", "1e-5", "--fault-check",
          "--watchdog", "120")


def test_launcher_device_config_scales_slots(monkeypatch):
    """--device-config scales the scheduler's slot budget to the top
    rung times the crossbar count (8 x 2 at n = 8)."""
    seen = []

    def spy(engine, reqs, **kw):
        seen.append(kw["max_slots"])
        return run_load(engine, reqs, **kw)

    monkeypatch.setattr(launcher, "run_load", spy)
    _main("--traffic", "6", "--device-config", "1x1x1x2",
          "--traffic-elems", "2")
    assert seen == [16]


@pytest.mark.parametrize("flags, key, value", [
    (("--traffic-slots", "2"), "max_slots", 2),
    (("--traffic-priority", "decode"), "priority", "decode")])
def test_launcher_traffic_flags_reach_the_scheduler(monkeypatch, flags,
                                                    key, value):
    """--traffic-slots clamps the slot budget and --traffic-priority
    picks the admission policy of the run the launcher serves."""
    seen = []

    def spy(engine, reqs, **kw):
        seen.append(kw)
        return run_load(engine, reqs, **kw)

    monkeypatch.setattr(launcher, "run_load", spy)
    rep = launcher.main(["--pim-backend", PORT, "--traffic", "6",
                         "--traffic-elems", "2", *flags])
    assert [kw[key] for kw in seen] == [value]
    assert rep.bit_exact and rep.recompiles == 0 and rep.n_requests == 6


def test_launcher_gate_that_cannot_hold_exits_nonzero():
    with pytest.raises(SystemExit) as exc:
        _main("--traffic", "8", "--traffic-check", "1000")
    assert exc.value.code not in (0, None)
    assert "FAILED" in str(exc.value.code)


def test_launcher_without_traffic_names_model_mode():
    """Without --traffic the launcher serves in model mode: prefill and
    greedy decode of --arch, returning the generated tokens."""
    run = launcher.main(["--smoke", "--pim-backend", PORT, "--batch", "2",
                         "--prompt-len", "4", "--gen", "2"])
    assert run.tokens.shape == (2, 2) and run.recompiles == 0


def test_launcher_default_backend_needs_cuda():
    """No --pim-backend means packed torch on CUDA: without a card the
    launcher raises rather than serving from the host."""
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default engine is valid here")
    with pytest.raises(RuntimeError, match="CUDA"):
        launcher.main(["--traffic", "2"])


def test_launcher_writes_trace_and_metrics(tmp_path):
    import json
    from repro_torch import obs
    trace, metrics = tmp_path / "t.json", tmp_path / "m.json"
    try:
        _main("--traffic", "4", "--trace", str(trace),
              "--metrics", str(metrics))
    finally:
        obs.disable()
        obs.reset_trace()
    names = {e["name"] for e in json.loads(trace.read_text())["traceEvents"]}
    assert {"serve.load", "serve.sched.step", "backend.kernel"} <= names
    assert json.loads(metrics.read_text())["counters"]["serve.sched.tokens"]


def test_request_tokens_identical_numpy_and_torch():
    """One trace through the port on numpy and torch: the same tokens per
    request, and both equal the plain-int reference."""
    reqs = generate(TrafficConfig(n_requests=10, rate=1e6, seed=11,
                                  n_bits=N_BITS))
    toks = []
    for spec in ("numpy:pack=true", PORT):
        b = ContinuousBatcher(Engine(spec), n_bits=N_BITS, max_slots=4)
        for r in reqs:
            b.queue.submit(r.fresh(), 0.0)
        b.warmup()
        b.run_until_idle()
        toks.append({r.rid: r.tokens for r in b.finished_reqs})
    assert toks[0] == toks[1]
    assert toks[0] == {r.rid: reference_tokens(r, N_BITS) for r in reqs}
    assert np.all([len(v) > 0 for v in toks[0].values()])
