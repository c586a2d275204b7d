"""Run one benchmark cell once and print its result line.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Runs on the card of the machine it is started on (exits non-zero, printing
no result, without enough CUDA devices). The last line of standard output is
the result's JSON object; the compared numbers and their limits are the last
lines of standard error. ``--control 1`` puts the reference, in fp8
operands, in the program's place and checks it against the same limits (the
benchmark's own runs never pass it).
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None, device=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    from portbench import harness

    harness.set_cache_dirs(ROOT)
    print(harness.card_line(), file=sys.stderr, flush=True)
    line = harness.execute(ROOT, args.workload, args.seed, args.seconds, bool(args.trace), T0,
                           device=device, control=bool(args.control))
    print(harness.card_line(), file=sys.stderr, flush=True)
    bad = harness.forbidden_modules()
    if bad:
        print(f"portbench: the run loaded {', '.join(bad)}", file=sys.stderr)
        return 3
    for name, c in line["checks"].items():
        ok = "ok" if c["value"] <= c["limit"] else "FAIL"
        print(f"[check] {name} {c['value']!r} limit {c['limit']!r} {ok}", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
