"""Find the serving knee: run a serving cell at several fixed rates, one
process a rate, and print for each the requests due in the window, the
replies that ended in it, and the median latency of the window's first and
second halves (a backlog that grows shows as a second half slower than the
first, and as fewer replies than arrivals).

  python3 -m hdrbench.sweep --workload serve-f32-mixed --rates 20,25,30 --seconds 20 --seed 1

The rate found goes into the mix's file by hand, as a number; the
benchmark's runs never search for one.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys


def one(workload: str, rate: float, seed: int, seconds: float) -> dict:
    import torch

    from hdrbench.run import cache_dirs, execute

    cache_dirs()
    code, line, out = execute(workload, seed, seconds, False, torch.device("cuda", 0),
                              {"rate_rps": rate})
    return {"rate_rps": rate, "p95_ms": line["metrics"]["serve_p95_ms"]["value"] if line else None,
            "correct": line["correct"] if line else None, "failed": out.failed, **out.counters}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", default="serve-f32-mixed")
    p.add_argument("--rates", required=True)
    p.add_argument("--seconds", type=float, default=20.0)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--one", type=float, default=None, help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.one is not None:
        print("SWEEP " + json.dumps(one(args.workload, args.one, args.seed, args.seconds)), flush=True)
        return 0
    for rate in args.rates.split(","):
        proc = subprocess.run([sys.executable, "-m", "hdrbench.sweep", "--workload", args.workload,
                               "--rates", rate, "--one", rate, "--seconds", str(args.seconds),
                               "--seed", str(args.seed)], capture_output=True, text=True)
        found = [ln for ln in proc.stdout.splitlines() if ln.startswith("SWEEP ")]
        print(found[-1][6:] if found else json.dumps({"rate_rps": float(rate), "rc": proc.returncode,
                                                      "stderr": proc.stderr[-2000:]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
