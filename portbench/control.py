#!/usr/bin/env python3
"""The control of the benchmark's correctness check, and the faults it must
catch, on the card:

    python3 portbench/control.py --workload march.jump \\
        --seeds 11,12,13,14 --control-seeds 2 --faults stale,half_burst \\
        --fault-seeds 3 --seconds 15

For each seed, one run of the cell at its own size and load for a short
window (long enough to reach every checked request), its checked requests
compared with the float32 reference: the program's readings, the lower
readings of the check's limits. On the first ``--control-seeds`` seeds the
same requests are also rendered by the reference in bfloat16 in the
program's place (the control, which the limits must fail), and on the
first ``--fault-seeds`` seeds the cell runs again with each fault of
``--faults`` planted in the program (harness/faults.py). One JSON line per
run, then a summary: the largest program reading, the smallest control
and fault readings of each number, beside its limit. The benchmark's own
runs never run this.
"""

import argparse
import json
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--faults", default="")
    ap.add_argument("--fault-seeds", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=15.0)
    args = ap.parse_args(argv)

    from harness import cli

    cli.setup_checkout()
    import torch

    from harness import cell, check, faults

    if not torch.cuda.is_available():
        print("control: no CUDA device is available", file=sys.stderr)
        return 3
    seeds = [int(s) for s in args.seeds.split(",")]
    planted = [f for f in args.faults.split(",") if f]
    low, high, limits = {}, {}, {}
    fault_low: dict = {f: {} for f in planted}
    caught: dict = {f: [] for f in planted}

    for n, seed in enumerate(seeds):
        ctl = n < args.control_seeds
        r = cell.run_cell(args.workload, seed, args.seconds, False,
                          time.perf_counter(), control=ctl, readings=True)
        limits = {k: c["limit"] for k, c in r["checks"].items()
                  if k != "requests_compared"}
        prog = r["program"]
        line = {"seed": seed, "correct": r["correct"], "program": prog,
                "compared": r["checks"]["requests_compared"]["value"]}
        if ctl:
            line.update(control=r["control"],
                        control_correct=r["control_correct"])
            for k in check.NAMES:
                high[k] = min(high.get(k, float("inf")), r["control"][k])
        print(json.dumps(line), flush=True)
        for k in check.NAMES:
            low[k] = max(low.get(k, 0.0), prog[k])
        if n >= args.fault_seeds:
            continue
        for f in planted:
            with faults.planted(f):
                rf = cell.run_cell(args.workload, seed, args.seconds, False,
                                   time.perf_counter(), readings=True)
            got = rf["program"]
            caught[f].append(not rf["correct"])
            print(json.dumps({"seed": seed, "fault": f,
                              "correct": rf["correct"], "readings": got}),
                  flush=True)
            for k in check.NAMES:
                fault_low[f][k] = min(fault_low[f].get(k, float("inf")),
                                      got[k])
    for k in check.NAMES:
        parts = [f"program at most {low[k]:.6g}"]
        if k in high:
            parts.append(f"control at least {high[k]:.6g}")
        parts += [f"{f} at least {fault_low[f][k]:.6g}" for f in planted]
        print(f"{k}: " + ", ".join(parts)
              + (f"; limit {limits[k]:.6g}" if k in limits else ""),
              flush=True)
    for f in planted:
        print(f"fault {f}: not correct in {sum(caught[f])} of "
              f"{len(caught[f])} runs", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
