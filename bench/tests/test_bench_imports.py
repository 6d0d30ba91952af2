"""A cell's set-up and run at smoke size, and every metric's reader,
load no JAX and no JAX package (top-level module names compared whole),
and open nothing under ``benchmarks/`` (the JAX package's benchmark).
The run goes in a fresh interpreter, under an audit hook that records
every file opened. A reader that loads such a module keeps the run from
printing a result."""
import json
import os
import subprocess
import sys
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

SCRIPT = r"""
import json, os, sys
root = sys.argv[1]
opened = []
def hook(event, args):
    if event == "open" and isinstance(args[0], (str, bytes, os.PathLike)):
        opened.append(os.fsdecode(args[0]))
sys.addaudithook(hook)
sys.path[:0] = [os.path.join(root, "bench"), os.path.join(root, "src"),
                os.path.join(root, "bench", "tests")]
import run as bench_run
from smoke import smoke_spec, smoke_traffic
spec = bench_run.load_json(bench_run.ROOT / "BENCHMARK.json")
metrics = spec["end_to_end"] + spec["per_layer"]
read = {}
for config, traffic in (("ds7b-pim", "decode"), ("ds7b-pim", "prefill"),
                        ("dsmoe16b-pim", "decode")):
    cell = {"name": config + "." + traffic, "config": config,
            "traffic": traffic, "chips": 1}
    out = bench_run.run_cell(cell, smoke_spec(config), smoke_traffic(traffic),
                             {"gap_max.prefill": 1.0}, seed=1,
                             seconds=0.05, trace=traffic == "decode",
                             device="cpu", backend="torch:device=cpu")
    for m in metrics:
        bench_run.reader(m["name"])(out["run"])
        read[m["name"]] = read.get(m["name"], 0) + 1
bench = os.path.join(root, "benchmarks")
print(json.dumps({
    "read": read,
    "top": sorted({m.split(".")[0] for m in sys.modules}),
    "benchmarks": sorted({p for p in opened
                          if os.path.abspath(p).startswith(bench + os.sep)}),
    "configs": sorted({p for p in opened if "configs" in p}),
}))
"""


def test_run_loads_no_jax_and_reads_no_jax_benchmark():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["REPRO_CACHE_DIR"] = "off"
    out = subprocess.run([sys.executable, "-c", SCRIPT, str(ROOT)],
                         capture_output=True, text=True, env=env,
                         timeout=600, cwd=str(ROOT))
    assert out.returncode == 0, out.stderr[-4000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    loaded = set(got["top"])
    assert "repro_torch" in loaded and "torch" in loaded
    assert not loaded & {"jax", "jaxlib", "flax", "repro"}, loaded
    assert got["benchmarks"] == []
    assert got["configs"], "the audit hook saw no file opened"
    # every metric's reader of BENCHMARK.json ran on every run (on the
    # CPU the device's readers find nothing to read and return None)
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    names = {m["name"] for m in bench["end_to_end"] + bench["per_layer"]}
    assert got["read"] == {name: 3 for name in names}


def test_forbidden_names_are_compared_whole():
    sys.path.insert(0, str(ROOT / "bench"))
    import run as bench_run
    assert "repro" in bench_run.FORBIDDEN
    # repro_torch starts with the JAX package's name and is allowed
    assert "repro_torch".split(".")[0] not in bench_run.FORBIDDEN
    names = {m.split(".")[0] for m in sys.modules}
    assert set(bench_run.forbidden_modules()) == names & set(
        bench_run.FORBIDDEN)


def test_reader_that_loads_jax_keeps_the_result_back(monkeypatch, capsys):
    """A metric's reader that loads a forbidden module (here a stand-in
    for ``flax``) makes the run exit 4 with no result line: the check
    comes after every reader has run."""
    sys.path.insert(0, str(ROOT / "bench"))
    import run as bench_run
    assert "flax" not in sys.modules

    def loads_flax(run):
        sys.modules["flax"] = types.ModuleType("flax")
        return 1.0
    monkeypatch.setattr(bench_run, "reader", lambda name: loads_flax)
    monkeypatch.delitem(sys.modules, "flax", raising=False)
    cell = {"name": "ds7b-pim.decode", "chips": 1}
    metric = {"name": "gen_tokens_per_s", "unit": "tokens/s"}
    try:
        rc = bench_run.report(cell, [metric], {"run": None}, False)
    finally:
        sys.modules.pop("flax", None)
    captured = capsys.readouterr()
    assert rc == 4
    assert captured.out == ""
    assert "flax" in captured.err
