"""Each cell's window times the phase it is named for, at smoke size on
the CPU: a decode window keeps a new job's prefill off its steps, its
clock and its peak, while that job is still served and compared; a
traffic whose answer is the prefill's one token runs no decode step; and
the end-to-end readers and ``mfu``/``peak_gib`` read a hand-built run as
their docstrings say."""
import itertools
import json
import time
from pathlib import Path

import pytest
import torch

import run as bench_run
from pimbench import work
from pimbench.config import model_config
from pimbench.serving import Job, Server, Step
from smoke import smoke_spec, smoke_traffic

BENCH = Path(__file__).resolve().parents[1]
LIMITS = {"gap_max.prefill": 1e-4, "gap_max.decode": 1e-4}
SLOW = 0.1      # seconds a prefill is held back in the slow-prefill test


def _cell(traffic):
    return {"name": f"ds7b-pim.{traffic}", "config": "ds7b-pim",
            "traffic": traffic, "chips": 1}


def _run(traffic, seconds, trace=False, **over):
    t = smoke_traffic(traffic)
    t.update(over)
    return bench_run.run_cell(
        _cell(traffic), smoke_spec("ds7b-pim"), t, LIMITS, seed=2 ** 32 + 9,
        seconds=seconds, trace=trace, device="cpu",
        backend="torch:device=cpu")


def _slow_prefill(monkeypatch):
    """Every prefill call held back by :data:`SLOW` seconds (inside the
    call, outside its own step's clock)."""
    real = Server._prefill

    def slow(self):
        time.sleep(SLOW)
        return real(self)
    monkeypatch.setattr(Server, "_prefill", slow)


def test_step_window_that_reaches_a_jobs_end_holds_decode_steps_alone(
        monkeypatch):
    """Answers of 2 tokens: set-up serves job 0 whole, so the window's
    first call is a new job's prefill and every decode step ends a job."""
    _slow_prefill(monkeypatch)
    out = _run("decode", 0.05, gen=2, cache_len=9)
    run = out["run"]
    assert run.steps and {s.kind for s in run.steps} == {"decode"}
    assert len(run.kept_off) == len(run.steps)
    assert {s.kind for s in run.kept_off} == {"prefill"}
    # the clock is the decode steps' seconds, and the loop's microseconds
    # between them; none of the prefills' held-back seconds
    spent = sum(s.seconds for s in run.steps)
    assert spent <= run.window_s < spent + 0.02
    assert run.steps[-1].t1 - run.steps[0].t0 > run.window_s + (
        SLOW * (len(run.kept_off) - 1))
    # the jobs prefilled in the window are served whole and compared
    served = {s.job for s in run.kept_off}
    assert all(run.jobs[i].n_served == 2 for i in served)
    assert served & {j.index for j in out["checked"]}
    assert out["correct"], out["check"]
    assert out["readings"]["positions.decode"] > 0
    # gen_tokens_per_s counts the steps' tokens alone
    gen = bench_run.reader("gen_tokens_per_s")(run)
    assert gen == pytest.approx(3 * len(run.steps) / run.window_s)


def test_traced_segment_of_a_step_window_runs_no_prefill(monkeypatch):
    """The profiled segment goes on with decode steps, after room was
    made off it, and stops at the job's end rather than prefill."""
    _slow_prefill(monkeypatch)
    out = _run("decode", 0.02, trace=True, gen=3, cache_len=10,
               trace_seconds=30.0)
    run = out["run"]
    assert run.traced_steps
    assert {s.kind for s in run.traced_steps} == {"decode"}
    assert {s.job for s in run.traced_steps} == {run.traced_steps[0].job}
    assert out["correct"], out["check"]


def test_gen_1_traffic_runs_no_decode_step(monkeypatch):
    """Scoring traffic (one token an answer, the cache the prompt's
    length): set-up serves one job, and the window and the profiled
    segment are prefills alone."""
    def no_decode(self):
        raise AssertionError("a decode step ran")
    monkeypatch.setattr(Server, "_decode", no_decode)
    traffic = json.loads((BENCH / "traffic" / "prefill.json").read_text())
    assert traffic["gen"] == 1 and traffic["cache_len"] == \
        traffic["prompt_len"]
    out = _run("prefill", 0.05, trace=True, gen=1, cache_len=8)
    run = out["run"]
    assert {s.kind for s in run.steps} == {"prefill"}
    assert {s.kind for s in run.traced_steps} == {"prefill"}
    assert run.steps[0].job == 1 and not run.kept_off
    assert all(j.n_served == 1 for j in run.jobs)
    assert out["correct"], out["check"]
    assert out["readings"]["positions.decode"] == 0
    assert out["readings"]["positions.prefill"] > 0
    assert bench_run.reader("prompt_tokens_per_s")(run) > 0


def test_warm_up_of_gen_1_is_one_prefill():
    calls = []

    class Stub(Server):
        def __init__(self, gen):
            self.gen, self.jobs = gen, []

        def advance(self):
            calls.append("prefill" if self.job_done() else "decode")
            if calls[-1] == "prefill":
                self.jobs.append(Job(len(self.jobs), None, 0.0))
            self.jobs[-1].served.append(None)
    assert Stub(1).warm_up("job") == 1 and calls == ["prefill"]
    calls.clear()
    assert Stub(4).warm_up("job") == 1
    assert calls == ["prefill"] + ["decode"] * 3
    calls.clear()
    assert Stub(4).warm_up("step") == 0 and calls == ["prefill", "decode"]


class _FakeAllocator:
    """``max_memory_allocated`` and ``reset_peak_memory_stats`` of a card
    on which a prefill peaks at 100 and a decode step at 10 (set-up's
    reset leaves 5)."""

    def __init__(self, monkeypatch):
        self.peak = 5
        monkeypatch.setattr(torch.cuda, "max_memory_allocated",
                            lambda *a: self.peak)
        monkeypatch.setattr(torch.cuda, "reset_peak_memory_stats",
                            lambda *a: setattr(self, "peak", 5))
        real_prefill, real_decode = Server._prefill, Server._decode

        def prefill(server):
            self.peak = max(self.peak, 100)
            return real_prefill(server)

        def decode(server):
            self.peak = max(self.peak, 10)
            return real_decode(server)
        monkeypatch.setattr(Server, "_prefill", prefill)
        monkeypatch.setattr(Server, "_decode", decode)


def _server(gen):
    from pimbench.weights import PromptStream, draw_weights
    from repro_torch.engine import Engine
    from repro_torch.models import build_model
    cfg = model_config(smoke_spec("ds7b-pim"), "ds7b-pim")
    model = build_model(cfg, engine=Engine("torch:device=cpu"))
    traffic = dict(smoke_traffic("decode"), gen=gen, cache_len=7 + gen)
    prompts = PromptStream(3, 3, 8, cfg.vocab_size, model.device)
    return Server(model, draw_weights(cfg, 3, model.device), traffic,
                  prompts)


def test_decode_window_peak_leaves_the_prefill_out(monkeypatch):
    """On a clock that reads one more at every look (three looks a call),
    15 s of window are 5 decode steps: the one left of job 0 and two each
    of jobs 1 and 2, whose prefills stay off its clock and its peak."""
    server = _server(gen=3)
    server.warm_up("step")
    alloc = _FakeAllocator(monkeypatch)
    server.cuda = True
    server.clock = lambda c=itertools.count(): float(next(c))
    win = server.run(15.0, "step")
    assert [s.kind for s in win.steps] == ["decode"] * 5
    assert [s.job for s in win.steps] == [0, 1, 1, 2, 2]
    assert [s.job for s in win.kept_off] == [1, 2]
    # 22 from the window's start to its last step's end, less the two
    # prefills' 3 each
    assert win.seconds == 16.0
    assert win.peak_bytes == 10
    assert win.kept_off_peak_bytes == 100
    assert alloc.peak == 10


def _hand_run(kind):
    cfg = model_config(json.loads(
        (BENCH / "configs" / "ds7b-pim.json").read_text()), "ds7b-pim")
    if kind == "decode":
        steps = [Step("decode", 0, 10.0 + i, 10.5 + i, 32, 0, 32 * 300)
                 for i in range(4)]
        kept_off = [Step("prefill", 1, 20.0, 22.5, 32, 32 * 256, 1)]
        return bench_run.Run(_cell("decode"), cfg, {"window_unit": "step"},
                             12.0, 2.0, steps, [], 3 * 2 ** 30,
                             kept_off=kept_off), cfg
    jobs = [Job(i, torch.zeros(4, 2048, dtype=torch.int32), 3.0 * i,
                first_token=3.0 * i + 2.8, done=3.0 * i + 2.8)
            for i in range(4)]
    steps = [Step("prefill", i, 3.0 * i, 3.0 * i + 2.8, 4, 8192,
                  4 * 2048 * 2049 // 2) for i in range(1, 4)]
    # job 0 was served in set-up: not the window's
    return bench_run.Run(_cell("prefill"), cfg, {"window_unit": "job"},
                         12.0, 8.8, steps, jobs, 0), cfg


def test_readers_of_a_hand_built_decode_run():
    run, cfg = _hand_run("decode")
    read = bench_run.reader
    # 4 steps of 32 tokens over the window's 2 s; the kept-off prefill's
    # 32 tokens and 2.5 s count in neither
    assert read("gen_tokens_per_s")(run) == pytest.approx(64.0)
    assert read("mfu.decode")(run) == pytest.approx(
        100 * work.model_flops(cfg, 128, 4 * 32 * 300) / 2.0 / work.PEAK_OPS)
    assert read("peak_gib.decode")(run) == pytest.approx(3.0)
    assert read("prompt_tokens_per_s")(run) is None


def test_readers_of_a_hand_built_prefill_run():
    run, cfg = _hand_run("prefill")
    read = bench_run.reader
    # jobs 1-3 prefilled and done in the window: 3 x 8,192 over 8.8 s
    assert read("prompt_tokens_per_s")(run) == pytest.approx(3 * 8192 / 8.8)
    assert read("mfu.prefill")(run) == pytest.approx(
        100 * work.model_flops(cfg, 3 * 8192, 3 * 4 * 2048 * 2049 // 2)
        / 8.8 / work.PEAK_OPS)
    assert read("peak_gib.prefill")(run) is None
    assert read("ttft_ms.prefill")(run) == pytest.approx(2800.0)
