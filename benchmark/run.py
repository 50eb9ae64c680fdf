"""Run one benchmark cell once and print its result as one JSON line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout, on a machine with the cards the cell asks for
(BENCHMARK.json). It sets up, measures for --seconds, checks what the
window produced against the plain reference (benchmark/reference/), and
prints the line last on standard output; progress and the compared
numbers with their limits go to standard error. It exits nonzero and
prints no result where CUDA is missing or has fewer cards than the cell
asks for, where the program cannot be imported, where the program holds
more than harness.HOLD_MAX (1024) frames pulled and not yet yielded,
where JAX or the JAX package is loaded when the window has closed, and
where a process it started cannot be stopped: every child (the check's
workers, the multiprocessing resource tracker their pool starts, the
compilers) has ended before the line is printed. The bound is above what
a streaming encoder holds in any configuration the port accepts (at most
the VBR lookahead's 502, at its largest, and two in flight); a program
that reads the endless feed to its end before it yields would grow in
host memory until it is killed, so the run stops at the bound, with one
line on standard error that names it, the frames held and the display
indices yielded so far.
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
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # one process with few threads: no idle thread pools spinning beside
    # the encoder's host thread, and one thread in each check worker
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "1"
    # every cache the program or torch may write stays in the checkout
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          os.path.join(ROOT, "build", "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR",
                          os.path.join(ROOT, "build", "triton"))
    for p in (ROOT, BENCH):
        if p not in sys.path:
            sys.path.insert(0, p)
    import harness
    cell = harness.entry(harness.manifest()["workloads"], args.workload)
    import torch
    torch.set_num_threads(1)
    if not torch.cuda.is_available():
        harness.log("no CUDA device: torch.cuda.is_available() is false")
        return 2
    if torch.cuda.device_count() < cell["chips"]:
        harness.log(f"{torch.cuda.device_count()} CUDA devices, the cell "
                    f"asks for {cell['chips']}")
        return 2
    try:
        out = harness.execute(args.workload, args.seed, args.seconds,
                              bool(args.trace), T_START)
    except harness.HeldFeed as e:
        harness.log(str(e))
        return 5
    finally:
        left = harness.stop_children()
        if left:
            harness.log(f"child processes still running after the run, "
                        f"stopped: {left}")
    if harness.children():
        harness.log("a child process could not be stopped")
        return 4
    found = harness.forbidden_modules()
    if found:
        harness.log(f"loaded in this process: {', '.join(found)}")
        return 3
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
