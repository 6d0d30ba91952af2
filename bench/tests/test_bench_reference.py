"""The plain reference against the port on the CPU at smoke widths, and
its controls: a run of the comparison with a lower precision in the
program's place fails it."""
import pytest
import torch

import run as bench_run
from pimbench.check import combine, control_gaps, judge, pick_jobs
from reference import Reference, reference_config
from smoke import smoke_spec, smoke_traffic

# The program and the reference agree to float rounding at smoke widths
# (0.0 in every run so far): the limit here is far under any control's.
SMOKE_LIMIT = 1e-4
LIMITS = {"gap_max.prefill": SMOKE_LIMIT, "gap_max.decode": SMOKE_LIMIT}


def _cell(config, traffic):
    return {"name": f"{config}.{traffic}", "config": config,
            "traffic": traffic, "chips": 1}


def _run(config, traffic, seed, **kw):
    return bench_run.run_cell(
        _cell(config, traffic), smoke_spec(config), smoke_traffic(traffic),
        LIMITS, seed=seed, seconds=0.3, trace=False, device="cpu",
        backend="torch:device=cpu", **kw)


@pytest.mark.parametrize("traffic", ["decode", "prefill"])
@pytest.mark.parametrize("seed", [3, 2 ** 33 + 1])
def test_reference_matches_port_prefill_and_decode(traffic, seed):
    out = _run("ds7b-pim", traffic, seed)
    check = out["check"]
    assert out["correct"], check
    assert out["readings"]["positions.prefill"] > 0
    assert out["readings"]["positions.decode"] > 0
    assert check["gap_max.prefill"]["value"] <= SMOKE_LIMIT
    assert check["gap_max.decode"]["value"] <= SMOKE_LIMIT


def test_moe_prefill_matches_and_decode_misses_the_prompt():
    """DeepSeekMoE: the prefill's logits (router top-k, the ragged expert
    dispatch, the shared experts, all on the PIM path) agree with the
    reference; decode positions do not, because the port's MoE block
    leaves no keys and values behind after a prefill (PERF.md, Open
    questions): a decode step attends over the answer only. When the port
    fills that cache, this test fails and the MoE cell can come in."""
    out = _run("dsmoe16b-pim", "decode", 5)
    check = out["check"]
    assert check["gap_max.prefill"]["value"] <= SMOKE_LIMIT
    assert check["gap_max.decode"]["value"] > 100 * SMOKE_LIMIT
    assert not out["correct"]


@pytest.mark.parametrize("control", [dict(n_bits=7), dict(n_bits=4)])
@pytest.mark.parametrize("config", ["ds7b-pim", "dsmoe16b-pim"])
def test_lower_precision_control_fails(config, control):
    spec, traffic = smoke_spec(config), smoke_traffic("decode")
    out = _run(config, "decode", 11)
    jobs = pick_jobs(out["run"].jobs, 0, 2, 11)
    cfg = reference_config(spec)
    params = out["params"]
    ref = Reference(cfg, params)
    ctl = Reference(cfg, params, **control)
    readings = combine([control_gaps(ref, ctl, j, "cpu") for j in jobs])
    worst = max(readings[f"gap_max.{part}"] for part in ("prefill", "decode"))
    assert worst > SMOKE_LIMIT, (config, control, worst)
    limits = {f"gap_max.{part}": SMOKE_LIMIT for part in ("prefill", "decode")}
    assert not judge(readings, limits)[1]


@pytest.mark.parametrize("traffic", ["decode", "prefill"])
def test_program_at_a_lower_pim_width_is_not_correct(traffic):
    """The program's own lower path (its PIM projections at 7 bits),
    judged by the reference at the configuration's 8 bits, comes out not
    correct through the run itself."""
    out = _run("ds7b-pim", traffic, 13, pim_bits=7)
    assert out["run"].cfg.pim_linear_bits == 7
    assert not out["correct"], out["check"]
    assert out["check"]["gap_max.prefill"]["value"] > SMOKE_LIMIT


def test_reference_config_reads_both_files():
    dense = reference_config(smoke_spec("ds7b-pim"))
    moe = reference_config(smoke_spec("dsmoe16b-pim"))
    assert dense.pim_head and dense.pim_ffn and dense.pim_attn
    assert dense.n_experts == 0 and moe.n_experts == 8
    assert moe.first_dense == 1 and moe.top_k == 2 and moe.n_shared == 2
    assert dense.pim_bits == moe.pim_bits == 8
