"""A benchmark cell's card memory: allocated, requested and reserved.

    python3 tools/torch_card_memory.py --workload <cell> --seed <n> \
        [--pictures 10] [--tree DIR] [--dims WxH]

On a machine with a CUDA card. Runs the cell's set-up (benchmark/
harness.Run: its source, the IDR and two P pictures) and then --pictures
more pictures through the same Encoder.encode_pictures, with no window
timing and no check, from the checkout DIR (default: this one; give
another checkout to measure its port with the same harness), at the
cell's picture size or --dims (e.g. 3840x2160). Prints one JSON line:

  max_alloc, max_requested   torch.cuda.max_memory_allocated() (what the
                             benchmark's peak_mem_gib reads) and the peak
                             of the bytes the program asked for; the
                             allocator rounds each block up, and a large
                             block served from a cached one that is less
                             than 1 MiB larger is not split
  max_reserved               torch.cuda.max_memory_reserved(): the
                             caching allocator's segments, CUDA graph
                             pools included
  used_open                  the card's used bytes (mem_get_info) with
                             the stream open
  reserved_closed,           torch.cuda.memory_reserved() once the stream
  reserved_emptied           is closed, and after torch.cuda.empty_cache()
  pools                      with the stream open, the bytes reserved in
                             each private memory pool (CUDA graphs), by
                             pool id
  p_chain_pool               the encoder's kept P-chain script
                             (gpu/chain_script.py): its pool's reserved
                             and allocated bytes (the static outputs and
                             what the graphs hold) and its static input
                             buffers' bytes; null where none is kept
  peak_rises                 the last 8 rises of max_alloc, each at the
                             exit of the innermost program span
                             (gpu.encode.stage / trace.span) open when it
                             was read: [span path, max_alloc, allocated,
                             requested]

Imports neither JAX nor the JAX package.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def pool_bytes(enc) -> dict:
    """The private pools' reserved bytes, and the kept P-chain script's
    pool and static inputs (none in a tree without scripts)."""
    import torch
    pools: dict = {}
    for seg in torch.cuda.memory_snapshot():
        pid = tuple(seg.get("segment_pool_id") or (0, 0))
        if pid != (0, 0):
            row = pools.setdefault(pid, [0, 0])
            row[0] += seg["total_size"]
            row[1] += seg["allocated_size"]
    script = getattr(getattr(enc, "_p_scripts", None), "script", None)
    mine = None
    if script is not None:
        got = pools.get(tuple(script.pool), [0, 0])
        static = (*script.src, *script.ref, script.hme, *script.col)
        mine = {"pool": list(script.pool), "reserved": got[0],
                "allocated": got[1],
                "static_in": sum(t.numel() * t.element_size()
                                 for t in static)}
    return {"pools": {str(list(k)): v[0] for k, v in pools.items()},
            "p_chain_pool": mine}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--pictures", type=int, default=10)
    ap.add_argument("--tree", default=ROOT)
    ap.add_argument("--dims", default=None, metavar="WxH")
    args = ap.parse_args(argv)
    dims = (tuple(int(v) for v in args.dims.split("x")) if args.dims
            else None)
    tree = os.path.abspath(args.tree)
    os.chdir(tree)
    for p in (tree, os.path.join(tree, "benchmark")):
        sys.path.insert(0, p)
    import torch
    torch.set_num_threads(1)
    if not torch.cuda.is_available():
        print("no CUDA device: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 2
    import harness
    from svt_hevc_tpu_torch import trace

    def requested(kind):
        return torch.cuda.memory_stats().get(f"requested_bytes.all.{kind}")

    stack, rises = [], []
    span = trace.span

    class Probe:
        def __init__(self, name, wait=False):
            self.name, self.inner = name, span(name, wait)

        def __enter__(self):
            stack.append(self.name)
            return self.inner.__enter__()

        def __exit__(self, *exc):
            out = self.inner.__exit__(*exc)
            m = torch.cuda.max_memory_allocated()
            if not rises or m > rises[-1][1]:
                rises.append(["/".join(stack), m,
                              torch.cuda.memory_allocated(),
                              requested("current")])
            stack.pop()
            return out

    trace.span = Probe
    try:
        run = harness.Run(args.workload, args.seed, 1.0, False, T_START,
                          dims=dims)
        run.setup()
        for _ in range(args.pictures):
            run.capture(next(run.gen))
        torch.cuda.synchronize()
        free, total = torch.cuda.mem_get_info()
        res = {"tree": tree, "workload": args.workload, "seed": args.seed,
               "pictures": len(run.pictures),
               "setup_s": run.record["setup_s"],
               "max_alloc": torch.cuda.max_memory_allocated(),
               "max_requested": requested("peak"),
               "max_reserved": torch.cuda.max_memory_reserved(),
               "used_open": total - free}
        res.update(pool_bytes(run.enc))
        run.gen.close()
        torch.cuda.synchronize()
        res["reserved_closed"] = torch.cuda.memory_reserved()
        torch.cuda.empty_cache()
        res["reserved_emptied"] = torch.cuda.memory_reserved()
        res["peak_rises"] = rises[-8:]
    finally:
        trace.span = span
        harness.stop_children()
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
