"""The controls of a cell's `correct`: runs of the cell with a fault
planted in the program (faults.py; by default the cell's "controls" in
cells/<cell>.json: the decoder's check's and the quality check's), one
per seed and fault in one process, at the cell's own size and window;
each has to come out not correct. Not part of the benchmark's runs.

    python3 benchmark/control.py --workload <cell> --seeds 11,12,13 \
        [--faults sao_skip,hme_off] [--seconds 40]

Prints one JSON line per run, with its compared numbers, and exits 0
only where every run came out not correct.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--faults", default=None)
    ap.add_argument("--seconds", type=float, default=40.0)
    args = ap.parse_args(argv)
    for p in (ROOT, BENCH):
        if p not in sys.path:
            sys.path.insert(0, p)
    import harness
    from faults import FAULTS
    failed_all = True
    t = T_START
    faults = (args.faults.split(",") if args.faults
              else harness.load_cell(args.workload)["controls"])
    for seed in (int(s) for s in args.seeds.split(",")):
        for fault in faults:
            with FAULTS[fault]():
                out = harness.execute(args.workload, seed, args.seconds,
                                      False, t)
            failed_all = failed_all and not out["correct"]
            print(json.dumps({"seed": seed, "fault": fault,
                              "correct": out["correct"],
                              "checks": out["checks"]}), flush=True)
            t = time.perf_counter()
    return 0 if failed_all else 1


if __name__ == "__main__":
    sys.exit(main())
