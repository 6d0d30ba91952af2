"""repro_torch's model-mode serving on the CPU: the prefill + greedy
decode loop (``launch.serve.serve_model``) on JAX parameters carried
across gives the reference's tokens, with PIM off and with every
projection on the PIM path; the launcher's model mode runs end to end on
``Engine("torch:device=cpu")`` with its compile-once gate, trace and
device placement, and refuses what the port does not serve."""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as jax_config  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.engine import Engine  # noqa: E402
from repro_torch.launch import serve as launcher  # noqa: E402
from repro_torch.models import build_model  # noqa: E402

pytestmark = pytest.mark.models

PORT = "torch:device=cpu,pack=true"


def _pim(cfg, scope):
    if scope is None:
        return cfg
    mode = {"head": "none", "ffn": "ffn", "full": "full"}[scope]
    return dataclasses.replace(cfg, pim_linear_mode="pim", pim_linear_bits=8,
                               pim_block_mode=mode)


def _reference_greedy(jm, jp, prompts, gen, cache_len):
    """The reference launcher's loop with an unjitted decode_step: its
    jitted serve step cannot run on a mesh-less host (the four known
    reference failures include it)."""
    b, s = prompts.shape
    states = jm.init_decode_state(b, cache_len)
    logits, states = jm.forward(jp, jnp.asarray(prompts), states=states)
    tok = jnp.argmax(logits[:, -1:], axis=-1).astype(jnp.int32)
    out = [np.asarray(tok)]
    for t in range(gen - 1):
        logits, states = jm.decode_step(
            jp, tok, jnp.full((b, 1), s + t, jnp.int32), states)
        tok = jnp.argmax(logits[:, -1:], axis=-1).astype(jnp.int32)
        out.append(np.asarray(tok))
    return np.concatenate(out, axis=1)


@pytest.mark.parametrize("arch", ["gemma2-9b", "deepseek-moe-16b"])
@pytest.mark.parametrize("scope", [None, "full"])
def test_serve_model_gives_the_reference_tokens(arch, scope):
    """Seeded prompts (2 x 8), 5 tokens each, cache 16: the same greedy
    tokens as the reference's forward + decode_step loop on the same
    parameters; zero recompiles during decode."""
    jm = jax_build(_pim(jax_config(arch, smoke=True), scope))
    jp = jm.init(jax.random.PRNGKey(0))
    eng = Engine(PORT)
    tm = build_model(_pim(get_config(arch, smoke=True), scope), engine=eng)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp))
    prompts = np.random.default_rng(0).integers(3, jm.cfg.vocab_size, (2, 8))
    want = _reference_greedy(jm, jp, prompts, 5, 16)
    run = launcher.serve_model(tm, tp, torch.from_numpy(prompts), eng,
                               gen=5, cache_len=16)
    assert run.tokens.dtype == np.int32 and run.tokens.shape == (2, 5)
    np.testing.assert_array_equal(run.tokens, want)
    assert run.recompiles == 0 and len(run.token_latency_us) == 4
    assert run.prefill_s > 0 and run.tokens_per_s > 0


def test_serve_model_feeds_the_encoder():
    """Whisper: the encoder's output rides the decode states; the tokens
    equal a hand loop over forward(enc_frames) + decode_step."""
    eng = Engine(PORT)
    tm = build_model(get_config("whisper-small", smoke=True), engine=eng)
    tp = tm.init(0)
    rng = np.random.default_rng(1)
    prompts = torch.from_numpy(rng.integers(3, 256, (1, 4)))
    frames = torch.from_numpy(rng.standard_normal(
        (1, tm.cfg.enc_frames, tm.cfg.d_model)).astype(np.float32))
    run = launcher.serve_model(tm, tp, prompts, eng, gen=3, cache_len=8,
                               frames=frames)
    logits, _ = tm.forward(tp, prompts, enc_frames=frames)
    assert int(run.tokens[0, 0]) == int(logits[0, -1].argmax())


def _main(*argv):
    try:
        return launcher.main(["--smoke", "--pim-backend", PORT, *argv])
    finally:
        obs.disable()
        obs.reset_trace()


def test_launcher_model_mode_traces_the_pim_phases(tmp_path):
    """--smoke --pim-scope full --trace: the run passes the compile-once
    gate; the trace holds the prefill and decode spans, the model's
    steps with each PIM projection under them and its phases under each
    projection, and the groups' waterfall counter tracks; no crossbar
    pass runs for the trace."""
    trace, metrics = tmp_path / "t.json", tmp_path / "m.json"
    run = _main("--pim-scope", "full", "--batch", "2", "--prompt-len", "6",
                "--gen", "3", "--trace", str(trace), "--metrics",
                str(metrics))
    assert run.tokens.shape == (2, 3) and run.recompiles == 0
    assert ((run.tokens >= 0) & (run.tokens < 256)).all()
    events = json.loads(trace.read_text())["traceEvents"]
    spans = [e for e in events if e.get("ph") == "X"]
    names = {e["name"] for e in spans}
    assert {"serve.prefill", "serve.decode_step", "model.forward",
            "model.decode_step", "pim.linear", "pim.weight",
            "pim.activation", "pim.product", "pim.dequant"} <= names
    assert not names & {"exec.group_run", "backend.kernel"}
    by_id = {e["id"]: e for e in spans}
    steps = [e for e in spans if e["name"] == "model.decode_step"]
    assert len(steps) == 2
    assert by_id[steps[0]["parent"]]["name"] == "serve.decode_step"
    for e in spans:
        if e["name"] == "pim.linear":
            assert by_id[e["parent"]]["name"] in ("model.forward",
                                                  "model.decode_step")
        if e["name"] in ("pim.weight", "pim.product"):
            assert by_id[e["parent"]]["name"] == "pim.linear"
    tracks = [e["args"]["name"] for e in events
              if e.get("ph") == "M" and e["name"] == "process_name"]
    assert any(t.startswith("waterfall: head") for t in tracks)
    assert any(t.startswith("waterfall: ffn") for t in tracks)
    assert sum(e.get("ph") == "C" for e in events) > 0
    # the modeled tracks start where the spans do, on the spans' clock
    t0 = min(e["ts"] for e in spans)
    t1 = max(e["ts"] + e["dur"] for e in spans)
    modeled = [e["ts"] for e in events
               if e.get("ph") == "C" and e.get("pid", 1) >= 2]
    assert min(modeled) == t0 and max(modeled) <= t1
    gauges = json.loads(metrics.read_text())["gauges"]
    assert gauges["serve.cycles_per_token"] > 0


def test_launcher_decode_steps_reuse_the_kept_weights(tmp_path, monkeypatch):
    """--smoke --pim-scope full, prefill then decode: every pim.weight
    under model.decode_step finds the weight quantized by the prefill
    (``cached``, one hit each), and the served tokens equal those of the
    same run with the kept quantization bypassed (every call quantizing
    its weight anew)."""
    from repro_torch.pim import quant

    argv = ("--pim-scope", "full", "--batch", "2", "--prompt-len", "6",
            "--gen", "4")
    trace = tmp_path / "t.json"
    hits = obs.counter("pim.weight_cache.hit")
    before = hits.value
    run = _main(*argv, "--trace", str(trace))
    spans = [e for e in json.loads(trace.read_text())["traceEvents"]
             if e.get("ph") == "X"]
    by_id = {e["id"]: e for e in spans}

    def in_decode(e):
        while e is not None and e["name"] != "model.decode_step":
            e = by_id.get(e["parent"])
        return e is not None

    weights = [e for e in spans if e["name"] == "pim.weight" and in_decode(e)]
    assert len(weights) >= 3 * 3      # three steps of several projections
    assert all(e["args"].get("cached") is True for e in weights)
    assert hits.value - before == len(weights)
    monkeypatch.setattr(quant, "_kept_weight_side",
                        lambda w, n_bits: quant._weight_side(w, n_bits))
    before = hits.value
    bypassed = _main(*argv)
    assert hits.value == before
    np.testing.assert_array_equal(run.tokens, bypassed.tokens)


def test_launcher_model_mode_is_deterministic():
    """Two identical runs (seed 0 parameters and prompts) give identical
    tokens."""
    a = _main("--arch", "qwen3-8b", "--gen", "3", "--batch", "2")
    b = _main("--arch", "qwen3-8b", "--gen", "3", "--batch", "2")
    np.testing.assert_array_equal(a.tokens, b.tokens)


def test_launcher_device_config_sheds_what_does_not_fit():
    """A one-crossbar device holds one of the three scope groups: the
    plan sheds the other two instead of failing, and serving goes on."""
    before = obs.dump()["counters"].get("plan.capacity_shed", 0)
    run = _main("--pim-scope", "full", "--gen", "2", "--batch", "1",
                "--device-config", "1x1x1x1")
    assert run.tokens.shape == (1, 2)
    assert obs.dump()["counters"]["plan.capacity_shed"] - before == 2


def test_launcher_refuses_model_parallel():
    with pytest.raises(SystemExit, match="model-parallel"):
        launcher.main(["--smoke", "--pim-backend", PORT,
                       "--model-parallel", "2"])


def test_launcher_model_mode_default_backend_needs_cuda():
    """Without --pim-backend the model is served on the card's engine:
    with no CUDA the launcher raises instead of serving from the host."""
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default engine is valid here")
    with pytest.raises(RuntimeError, match="CUDA"):
        launcher.main(["--smoke", "--gen", "2"])
