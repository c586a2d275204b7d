"""Readings of the compared numbers over many seeds in one process, for the
limits of ``workloads/<cell>.json``: the program's (sound runs) and the
control's (the reference in fp8 operands in the program's place).

    python3 portbench/calibrate.py --workload <name> --seeds 1 2 3 ... [--control]

One JSON line a seed on standard output, and a summary line last. Not run by
the benchmark's own runs.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None, device=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--fault", choices=("half",), default=None,
                    help="the program with this fault planted (train cells)")
    args = ap.parse_args(argv)
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    import torch

    from portbench import harness

    harness.set_cache_dirs(ROOT)
    torch.set_num_threads(harness.THREADS)
    cell = harness.load_cell(ROOT, args.workload)
    dev = torch.device(device) if device is not None else torch.device("cuda", 0)
    kind = "control" if args.control else (args.fault or "program")
    driver = cell.driver()
    rows = []
    for seed in args.seeds:
        t = time.perf_counter()
        run = harness.Run(cell, seed, 0.0, False, dev, t)
        numbers = driver.readings(run, kind)
        numbers = {k: v for k, v in numbers.items() if isinstance(v, (int, float, str))}
        numbers.update(seed=seed, kind=kind, seconds=time.perf_counter() - t)
        rows.append(numbers)
        print(json.dumps(numbers), flush=True)
    keys = [k for k in cell.limits["limits"] if k in rows[0]]
    pick = max if kind == "program" else min  # the lower reading, or the upper
    print(json.dumps({"kind": kind, "workload": args.workload,
                      **{k: pick(r[k] for r in rows) for k in keys}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
