"""The comparison catches a broken timed path: a run at smoke size on
the CPU (the harness's look for a card skipped), with the port broken
underneath, comes out not correct, once for each fault a serving cell
can have. (One card: no exchange between cards to leave out.)"""
import pytest
import torch

import run as bench_run
from smoke import smoke_spec, smoke_traffic

LIMITS = {"gap_max.prefill": 1e-4, "gap_max.decode": 1e-4}


def _run(traffic="decode"):
    cell = {"name": f"ds7b-pim.{traffic}", "config": "ds7b-pim",
            "traffic": traffic, "chips": 1}
    return bench_run.run_cell(
        cell, smoke_spec("ds7b-pim"), smoke_traffic(traffic), LIMITS,
        seed=21, seconds=0.2, trace=False, device="cpu",
        backend="torch:device=cpu")


def _token_altered(monkeypatch):
    """A served token altered where it is produced: row 0's greedy token
    one above the argmax, in the prefill and in every decode step."""
    from repro_torch.train import step
    real = step.greedy_token

    def altered(cfg, logits, mesh=None):
        tok = real(cfg, logits, mesh).clone()
        tok[0] = (tok[0] + 1) % cfg.vocab_size
        return tok
    monkeypatch.setattr(step, "greedy_token", altered)


def _state_unchanged(monkeypatch):
    """A decode step that returns its state unchanged: the new key and
    value go into a copy of the cache, and its length does not move."""
    from repro_torch.models import blocks
    from repro_torch.models.attention import KVCache
    real = blocks.decode_attend

    def unchanged(q, cache, k_new, v_new, **kw):
        o, _ = real(q, KVCache(cache.k.clone(), cache.v.clone(),
                               cache.length), k_new, v_new, **kw)
        return o, cache
    monkeypatch.setattr(blocks, "decode_attend", unchanged)


def _half_batch(monkeypatch):
    """Half of the batch left out: a decode step's second half of the rows
    gets the first half's logits."""
    from repro_torch.models import transformer
    real = transformer.decode_step

    def half(*a, **kw):
        logits, states = real(*a, **kw)
        n = logits.shape[0] // 2
        logits = logits.clone()
        logits[n:2 * n] = logits[:n]
        return logits, states
    monkeypatch.setattr(transformer, "decode_step", half)


def test_sound_run_is_correct():
    out = _run()
    assert out["correct"], out["check"]


@pytest.mark.parametrize("fault", [_token_altered, _state_unchanged,
                                   _half_batch])
def test_broken_timed_path_is_not_correct(fault, monkeypatch):
    fault(monkeypatch)
    out = _run()
    assert not out["correct"], out["check"]
    assert out["check"]["gap_max.decode"]["value"] > LIMITS["gap_max.decode"]
