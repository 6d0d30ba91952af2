"""The port's training launcher (``repro_torch.launch.train``) on the CPU:
smoke runs through ``--pim-backend torch:device=cpu`` with and without
``--ckpt-dir`` (resume included), its trace and metrics files, the
losses against a direct run of ``make_train_step`` on the same stream,
its refusals (no CUDA without a CPU spec, a ``--model-parallel`` the
ranks do not divide), and a sharded run: two ranks under
``torch.distributed.run`` with gloo and ``--model-parallel 2`` give the
one-rank run's losses."""
import json
import os
import signal
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import obs  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data import DataConfig, make_batch_fn  # noqa: E402
from repro_torch.engine import Engine  # noqa: E402
from repro_torch.launch import train as launcher  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.model import abstract_params  # noqa: E402
from repro_torch.optim import AdamWConfig  # noqa: E402
from repro_torch.train import latest_step, make_train_step  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

pytestmark = pytest.mark.infra

SRC = Path(__file__).resolve().parents[1] / "src"
CPU_ARGS = ["--arch", "qwen3-8b", "--smoke", "--pim-backend",
            "torch:device=cpu", "--seq-len", "32", "--global-batch", "4"]


@pytest.fixture(autouse=True)
def _fresh_obs():
    obs.reset_trace()
    obs.reset_metrics()
    yield
    obs.disable()
    obs.reset_trace()


def test_launcher_trains_and_reports(tmp_path):
    """Four steps with two microbatches: finite losses equal to a direct
    ``make_train_step`` run from the same seed on the same stream (the
    launcher adds nothing to the arithmetic); the trace holds one
    ``train.step`` span a step, the metrics the step histogram and the
    tokens/s gauge, the log file one line a step."""
    trace, metrics, logf = (tmp_path / "t.json", tmp_path / "m.json",
                            tmp_path / "log.csv")
    run = launcher.main(CPU_ARGS + [
        "--steps", "4", "--microbatches", "2", "--warmup", "2",
        "--trace", str(trace), "--metrics", str(metrics),
        "--log-file", str(logf)])
    assert run.start == 0 and len(run.losses) == 4 == len(run.step_s)
    assert all(np.isfinite(run.losses)) and run.tokens_per_step == 128
    events = json.loads(trace.read_text())["traceEvents"]
    steps = [e for e in events if e.get("name") == "train.step"]
    assert [e["args"]["step"] for e in steps] == [0, 1, 2, 3]
    snap = json.loads(metrics.read_text())
    assert snap["histograms"]["train.step_ms"]["count"] == 4
    assert snap["gauges"]["train.tokens_per_sec"] > 0
    assert len(logf.read_text().splitlines()) == 4

    cfg = get_config("qwen3-8b", smoke=True)
    model = build_model(cfg, remat=True, engine=Engine("torch:device=cpu"))
    step, init_fn, _ = make_train_step(
        model, AdamWConfig(lr=3e-4, warmup_steps=2, total_steps=4),
        microbatches=2)
    state = init_fn(0)
    stream = make_batch_fn(DataConfig(vocab_size=cfg.vocab_size,
                                      seq_len=32, global_batch=4))
    for s, want in enumerate(run.losses):
        b = {k: torch.from_numpy(v) for k, v in stream(s).items()}
        *state, met = step(*state, b)
        assert float(met["loss"]) == want


def test_launcher_checkpoints_and_resumes(tmp_path):
    """With ``--ckpt-dir`` the retrying runner trains and checkpoints;
    a second launch resumes from the newest step and finishes the run;
    with ``--compress-grads`` too."""
    ckpt = str(tmp_path / "ckpt")
    first = launcher.main(CPU_ARGS + ["--steps", "4", "--ckpt-dir", ckpt,
                                      "--ckpt-every", "2",
                                      "--compress-grads"])
    assert first.start == 0 and first.runner["restarts"] == 0
    assert latest_step(ckpt) == 4 and np.isfinite(first.losses[-1])
    second = launcher.main(CPU_ARGS + ["--steps", "6", "--ckpt-dir", ckpt,
                                       "--ckpt-every", "2"])
    assert second.start == 4 and latest_step(ckpt) == 6
    params, opt, _ = second.state
    assert int(opt.count) == 6
    assert all(p.requires_grad for p in tree_leaves(params))


def test_launcher_needs_cuda_unless_asked_for_the_cpu():
    """Without ``--pim-backend`` the model lives on the card: with no
    CUDA the launcher raises instead of training on the host."""
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default engine is valid here")
    with pytest.raises(RuntimeError, match="CUDA"):
        launcher.main(["--arch", "qwen3-8b", "--smoke", "--steps", "1"])


def test_launcher_refuses_model_parallel():
    """Without a process group there is one rank: ``--model-parallel 2``
    does not divide it, and the launcher says to run under
    ``torch.distributed.run``."""
    with pytest.raises(SystemExit, match="model-parallel"):
        launcher.main(CPU_ARGS + ["--model-parallel", "2"])


def test_launcher_sharded_matches_one_rank(tmp_path):
    """Two ranks under ``python -m torch.distributed.run`` on the CPU
    (gloo), on a (1, 2) mesh, three steps with two
    microbatches: losses, grad norms and lr within 1e-5 relative of the
    one-rank run (only the order of float32 sums changes), and each
    rank's placed parameter and AdamW bytes exactly the dry-run's count
    for the mesh."""
    from repro_torch.launch.dryrun import train_state_bytes
    from repro_torch.launch.mesh import abstract_mesh
    model_parallel = 2
    args = CPU_ARGS + ["--steps", "3", "--microbatches", "2",
                       "--warmup", "2"]
    one = launcher.main(args)
    out = tmp_path / "summary.json"
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1")
    # A session of its own: torchrun's signals stay in its group, and a
    # timeout ends it with its ranks.
    proc = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "repro_torch.launch.train"]
        + args + ["--model-parallel", str(model_parallel),
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
    dp = 2 // model_parallel
    assert got["mesh"] == {"data": dp, "model": model_parallel}
    for k, want in (("losses", one.losses), ("grad_norms", one.grad_norms),
                    ("lrs", one.lrs)):
        np.testing.assert_allclose(got[k], want, rtol=1e-5)
    cfg = get_config("qwen3-8b", smoke=True)
    expect = train_state_bytes(cfg, abstract_mesh(
        (dp, model_parallel), ("data", "model")),
        params=abstract_params(cfg, torch.float32))
    assert got["placed_bytes"] == [expect, expect]
    assert one.placed_bytes == [train_state_bytes(
        cfg, abstract_mesh((1, 1), ("data", "model")),
        params=abstract_params(cfg, torch.float32))]
