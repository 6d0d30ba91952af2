"""Smoke-width copies of the benchmark's configurations and traffic, for
the CPU tests: the same keys, every width cut down."""
import json
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]


def smoke_spec(name: str) -> dict:
    """``bench/configs/<name>.json`` at smoke widths."""
    spec = json.loads((BENCH / "configs" / f"{name}.json").read_text())
    spec.update(hidden_size=64, num_attention_heads=4, num_key_value_heads=4,
                intermediate_size=96, vocab_size=256)
    if spec.get("n_routed_experts"):
        spec.update(n_routed_experts=8, num_experts_per_tok=2,
                    n_shared_experts=2, moe_intermediate_size=32,
                    num_hidden_layers=3)
    else:
        spec.update(num_hidden_layers=2)
    return spec


def smoke_traffic(name: str) -> dict:
    """``bench/traffic/<name>.json`` at smoke sizes."""
    traffic = json.loads((BENCH / "traffic" / f"{name}.json").read_text())
    traffic.update(batch=3, prompt_len=8, gen=5, cache_len=12,
                   trace_seconds=0.0)
    return traffic
