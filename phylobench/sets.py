"""Run cells several times, each run its own process, and report the
spreads from which the bounds are set.

    python3 -m phylobench.sets --workload birds48.probe --seeds 11 12 13 \
        --seconds 20 [--trace 0|1] [--clv-dtype bf16] [--out DIR]

Each run is `python3 -m phylobench ...` as the driver starts it; its
last line is kept in DIR/<workload>.jsonl with its seed, exit code and
the end of its standard error.  The summary gives, for every metric, the
median and the spread: the distance between the first and third
quartiles (statistics.quantiles, n=4) as a share of the median.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def spread(values):
    if len(values) < 2:
        return None
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)


def one(workload, seed, seconds, trace, extra):
    cmd = [sys.executable, "-m", "phylobench", "--workload", workload,
           "--seed", str(seed), "--seconds", str(seconds), "--trace",
           str(trace)] + extra
    t = time.perf_counter()
    p = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True)
    row = {"seed": seed, "rc": p.returncode,
           "process_s": time.perf_counter() - t,
           "stderr_tail": p.stderr[-1500:]}
    lines = p.stdout.strip().splitlines()
    if p.returncode == 0 and lines:
        row["result"] = json.loads(lines[-1])
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m phylobench.sets")
    ap.add_argument("--workload", nargs="+", required=True)
    ap.add_argument("--seeds", nargs="+", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, default=0)
    ap.add_argument("--clv-dtype", default=None)
    ap.add_argument("--out", default=str(ROOT / "chiprun_out"))
    args = ap.parse_args(argv)
    extra = ["--clv-dtype", args.clv_dtype] if args.clv_dtype else []
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    tag = "" if not args.clv_dtype else "." + args.clv_dtype
    for w in args.workload:
        rows = []
        with open(out / f"{w}{tag}.t{args.trace}.jsonl", "a") as f:
            for s in args.seeds:
                row = one(w, s, args.seconds, args.trace, extra)
                rows.append(row)
                f.write(json.dumps(row) + "\n")
                f.flush()
                res = row.get("result", {})
                print(w, s, row["rc"], round(row["process_s"], 1),
                      json.dumps({k: v["value"] for k, v in
                                  res.get("metrics", {}).items()}),
                      json.dumps({k: v["value"] for k, v in
                                  res.get("checks", {}).items()}),
                      res.get("correct"),
                      res.get("device", {}).get("memory_peak_bytes"),
                      flush=True)
                if row["rc"] != 0:
                    print(row["stderr_tail"], flush=True)
        ok = [r["result"] for r in rows if "result" in r]
        names = sorted({k for r in ok for k in r["metrics"]})
        for n in names:
            vals = [r["metrics"][n]["value"] for r in ok
                    if n in r["metrics"]]
            print(f"SUMMARY {w}{tag} {n}: median {statistics.median(vals)!r}"
                  f" spread {spread(vals)!r} n {len(vals)} "
                  f"values {vals!r}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
