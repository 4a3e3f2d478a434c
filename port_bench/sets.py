"""Run a cell as the driver does, each run a fresh process, and print each
result line and the spread of every metric:

    python3 -m port_bench.sets --workload <cell> --seeds 1,2,3,4,5,6 [--sets 2] \
        [--trace 0] [--seconds N]

A set runs every seed once, in order; ``--sets`` repeats the set with the
same seeds. After the runs, one JSON line per set gives, for each metric, its
values, median and spread (``stats.spread``: the distance between the
quartiles as a share of the median), and how many runs were correct; the
first run of the call, which may compile, is left out of ``setup_s``'s.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys

from port_bench import spec, stats


def once(name: str, seed: int, seconds: float, trace: int) -> dict | None:
    proc = subprocess.run(
        [sys.executable, "-m", "port_bench.run", "--workload", name, "--seed", str(seed),
         "--seconds", str(seconds), "--trace", str(trace)],
        cwd=spec.ROOT, capture_output=True, text=True, timeout=1200)
    lines = proc.stdout.strip().splitlines()
    if proc.returncode != 0 or not lines:
        print(json.dumps({"seed": seed, "rc": proc.returncode,
                          "stderr": proc.stderr[-3000:]}), flush=True)
        return None
    print(json.dumps({"seed": seed, "result": json.loads(lines[-1]),
                      "stderr": proc.stderr.strip().splitlines()[-4:]}), flush=True)
    return json.loads(lines[-1])


def summary(results: list, skip_first_setup: bool) -> dict:
    values: dict = {}
    for i, r in enumerate(results):
        for name, m in r["metrics"].items():
            if name == "setup_s" and skip_first_setup and i == 0:
                continue
            values.setdefault(name, []).append(m["value"])
    out = {"runs": len(results), "correct": sum(r["correct"] for r in results)}
    for name, vs in values.items():
        out[name] = {"median": statistics.median(vs), "values": vs,
                     "spread": stats.spread(vs) if len(vs) >= 2 else None}
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True, help="comma-separated")
    parser.add_argument("--sets", type=int, default=1)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    parser.add_argument("--seconds", type=float)
    args = parser.parse_args(argv)
    seconds = args.seconds or spec.load_json(spec.ROOT / "BENCHMARK.json")["run_seconds"]
    seeds = [int(s) for s in args.seeds.split(",")]
    failed = 0
    for k in range(args.sets):
        results = [once(args.workload, s, seconds, args.trace) for s in seeds]
        failed += sum(r is None or not r["correct"] for r in results)
        done = [r for r in results if r is not None]
        print(json.dumps({"workload": args.workload, "set": k,
                          **summary(done, skip_first_setup=k == 0)}), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
