#!/usr/bin/env python
"""Run the north-star scene and the BASELINE preset configs through
bench.py, one after another, each in its own process (one JAX process on
the card at a time; the persistent compile cache is shared).

Prints each config's JSON line as it finishes; with --out, merges them
into a JSON list there (a failed rerun keeps the last good entry).

Usage: python -u tools/bench_all.py [--configs 0,1,2,3,4,5,5h,6,7]
                                    [--out results.json]
"""

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_one(arg, timeout):
    cmd = [sys.executable, "-u", os.path.join(ROOT, "bench.py")]
    if arg == "5h":  # config 5 with half-res shadow rays
        cmd += ["--config", "5", "--rt-scale", "2"]
    elif arg:
        cmd += ["--config", str(arg)]
    try:
        p = subprocess.run(cmd, capture_output=True, text=True,
                           timeout=timeout, cwd=ROOT)
    except subprocess.TimeoutExpired:
        return {"config": arg, "error": f"timeout after {timeout}s"}
    line = ""
    for ln in p.stdout.splitlines():
        if ln.strip().startswith("{"):
            line = ln.strip()
    if p.returncode != 0 or not line:
        return {"config": arg, "error": (p.stderr or p.stdout)[-800:]}
    d = json.loads(line)
    d["config"] = arg
    return d


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--configs", default="0,1,2,3,4,5,5h,6,7")
    ap.add_argument("--out", default=None)
    ap.add_argument("--timeout", type=int, default=1200,
                    help="seconds per config")
    args = ap.parse_args()

    results = []
    if args.out and os.path.exists(args.out):
        with open(args.out) as f:
            results = json.load(f)
    failed = 0
    for c in [x if x == "5h" else int(x) for x in args.configs.split(",")]:
        print(f"# running config {c} ...", flush=True)
        r = run_one(c, args.timeout)
        print(json.dumps(r), flush=True)
        if "error" in r:
            failed += 1
            if any(x.get("config") == c and "error" not in x
                   for x in results):
                continue  # keep the last good entry
        results = [x for x in results if x.get("config") != c] + [r]
        if args.out:
            with open(args.out, "w") as f:
                json.dump(results, f, indent=2)
                f.write("\n")
    sys.exit(1 if failed else 0)


if __name__ == "__main__":
    main()
