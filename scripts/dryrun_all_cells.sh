#!/usr/bin/env bash
# Every dry-run record (each arch x shape cell on both production
# meshes, 64 records), one process a record, JOBS at a time, then one
# line a record and how many fit the card. Run from the repo root. On
# the card (the default) each peak is held against its memory; with
# DRYRUN_DEVICE=cpu, against the stated capacity of an H100 80GB HBM3.
# Extra flags go to every record's dry-run (e.g. --rank-only).
#
#   scripts/dryrun_all_cells.sh OUT_DIR [JOBS [flags...]]
set -euo pipefail
out=${1:?usage: dryrun_all_cells.sh OUT_DIR [JOBS [flags...]]}
jobs=${2:-8}
shift $(( $# < 2 ? $# : 2 ))
mkdir -p "$out"
export PYTHONPATH=src${PYTHONPATH:+:$PYTHONPATH}
flags="$*"
[ "${DRYRUN_DEVICE:-}" = cpu ] && flags="$flags --device cpu"
# one command a record, the longest first (prefill_32k, then train_4k)
python - "$out" "$flags" > "$out/jobs.txt" <<'PY'
import sys
from repro_torch.configs import ARCHS, SHAPES, get_config
from repro_torch.configs.shapes import shape_applicable
out, flags = sys.argv[1], sys.argv[2]
order = {"prefill_32k": 0, "train_4k": 1, "long_500k": 2, "decode_32k": 3}
cells = [(a, s.name) for a in sorted(ARCHS) for s in SHAPES
         if shape_applicable(get_config(a), s)[0]]
for a, s in sorted(cells, key=lambda c: order[c[1]]):
    for pod in ("", "--multi-pod"):
        tag = f"{out}/{a}-{s}{'-pod' if pod else ''}"
        print(f"python -m repro_torch.launch.dryrun --arch {a} --shape {s} "
              f"{pod} {flags} --out {tag}.json > {tag}.log 2>&1 "
              f"|| echo FAILED {tag}")
PY
xargs -P "$jobs" -I{} bash -c '{}' < "$out/jobs.txt"
python - "$out" <<'PY'
import glob, json, sys
recs = [r for f in sorted(glob.glob(sys.argv[1] + "/*.json"))
        for r in json.load(open(f))]
ok = [r for r in recs if r["status"] == "ok"]
for r in ok:
    pd, tr = r["per_device"], r["trace"]
    print(json.dumps({"arch": r["arch"], "shape": r["shape"],
                      "mesh": r["mesh"], "peak_bytes": pd["peak_bytes"],
                      "temp_bytes": pd["temp_bytes"],
                      "full_width_temp_bytes": tr["full_width_temp_bytes"],
                      "per_rank": tr["per_rank"], "fits": r["card"]["fits"],
                      "collective_bytes": r["collective_bytes"],
                      "bytes_accessed": r["bytes_accessed"],
                      "trace_s": tr["seconds"]}))
print(json.dumps({"records": len(recs), "ok": len(ok),
                  "fit": sum(r["card"]["fits"] for r in ok),
                  "card": ok[0]["card"]["name"] if ok else None}))
PY
