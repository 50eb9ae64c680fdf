"""A benchmark cell with the port's tracer on: where the card's idle time goes.

    python3 tools/torch_trace_cell.py --workload <cell> --seed <n> \
        [--seconds 40]
    python3 tools/torch_trace_cell.py --workload <cell> --seed <n> \
        --on-cost PAIRS [--pictures 64]

From the root of a checkout, on a machine with a CUDA card.

The first form is benchmark/run.py's traced run (--trace 1) of the cell,
unchanged but for three additions to its record: a trace.Tracer runs
from before the profiled part to the end of the window (record key
"program": what Tracer.stop() returns), the profiled part on the host
clock ("part1_ns") and every device idle interval of the profiled part,
placed on the host clock with the run's own trace offset ("idle_ns").
It prints the run's result line, then one JSON line {"program": ...}
with the quantities of program_metrics() below and the profiled part's
idle seconds by the innermost program span open there ("idle_by_span";
"bench.capture" where only the benchmark's own stamp is open, null where
nothing is). A second tracer runs over the set-up alone; the line's
"p_capture_setup" counts the P-chain scripts recorded there ("p.capture"
spans) and their host milliseconds, "p_capture" those of the window,
and "p_chain_graph_share" is the share of the window's P chains replayed
from a script.

--on-cost: instead, the cell's set-up (its source, the IDR and two P
pictures), then 2 x PAIRS blocks of --pictures pictures each through the
same Encoder.encode_pictures, with the tracer off and on in the order
off, on, on, off, ...; prints each block's pictures per second and the
medians, and the device activities torch.profiler sees while the tracer
records 1000 empty spans (their CUDA events; none is expected).

Imports neither JAX nor the JAX package.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import bisect  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(ROOT, "benchmark")
for _p in (ROOT, BENCH):
    if _p not in sys.path:
        sys.path.insert(0, _p)

# the fused P chain's five stages (the benchmark's p_chain_ms)
CHAIN = ("p.dense_md_p", "p.decide_tree_dev", "p.merge_snap",
         "p.encode_pass_p_direct", "p._finish_fused")
# stages whose host work is enqueueing device work
LAUNCHING = ("p.upload", "p.hme_search", *CHAIN, "p.intra_wavefront_pass",
             "la.complexities")


def _ms(iv) -> float | None:
    if iv is None or iv[1] is None:
        return None
    return (iv[1] - iv[0]) / 1e6


def per_picture_ms(spans, names, clock: str = "host_ns") -> dict:
    """Per picture (span "pic"), the summed milliseconds of the spans
    named in names on clock "host_ns" or "device_ns"."""
    out: dict = {}
    for s in spans:
        ms = _ms(s[clock]) if s["name"] in names else None
        if ms is not None:
            out[s["pic"]] = out.get(s["pic"], 0.0) + ms
    return out


def p_chain_ms(prog, clock: str = "host_ns"):
    """Mean over the P pictures of the fused chain's summed spans: on the
    host clock, the host's enqueue cost (p_chain_launch_ms); on the
    device events, the device's interval (p_chain_device_ms)."""
    got = per_picture_ms(prog["spans"], CHAIN, clock)
    got.pop(None, None)
    return sum(got.values()) / len(got) if got else None


def lookahead_ms_per_frame(prog):
    """la.complexities' host milliseconds over the frames analysed."""
    n = prog["counters"].get("la.frames", 0)
    ms = [_ms(s["host_ns"]) for s in prog["spans"]
          if s["name"] == "la.complexities"]
    ms = [m for m in ms if m is not None]
    return sum(ms) / n if n and ms else None


def _clip(iv, lo: int, hi: int) -> int:
    if iv is None or iv[1] is None:
        return 0
    return max(0, min(iv[1], hi) - max(iv[0], lo))


def host_wait_ms(prog, part1):
    """Per picture dispatched in the profiled part, the host's
    milliseconds in wait spans (the "wait" flag; waits do not nest)
    inside it."""
    lo, hi = part1
    pics = {s["pic"] for s in prog["spans"] if s["name"] == "pic.dispatch"
            and s["pic"] is not None and lo <= s["host_ns"][0] < hi}
    if not pics:
        return None
    wait = sum(_clip(s["host_ns"], lo, hi) for s in prog["spans"]
               if s["wait"])
    return wait / 1e6 / len(pics)


def timeline(rows) -> list[tuple[int, int, object]]:
    """rows: (start, end, key, rank). Between each two consecutive
    boundaries, the key of the innermost row open there: of the open rows
    the one of highest rank, then the one that started last (None where
    none is open). Returns [(t0, t1, key)], contiguous."""
    ev = []
    for i, (a, b, _, _) in enumerate(rows):
        if b is not None and b > a:
            ev += [(a, 1, i), (b, 0, i)]
    ev.sort()
    open_: dict[int, tuple] = {}
    out = []
    for k, (t, start, i) in enumerate(ev):
        if start:
            open_[i] = (rows[i][3], rows[i][0], i)
        else:
            del open_[i]
        if k + 1 < len(ev) and ev[k + 1][0] > t:
            top = max(open_.values()) if open_ else None
            out.append((t, ev[k + 1][0],
                        None if top is None else rows[top[2]][2]))
    return out


def idle_by_span(spans, idle, stamps=()) -> dict:
    """Seconds of the idle intervals ([a, b] ns, host clock) by the name
    of the innermost program span open there; where none is, the
    innermost of stamps ((name, a, b), the benchmark's own), else None."""
    rows = [(s["host_ns"][0], s["host_ns"][1], s["name"], 1) for s in spans]
    rows += [(a, b, name, 0) for name, a, b in stamps]
    segs = timeline(rows)
    starts = [s[0] for s in segs]
    out: dict = {}
    for a, b in idle:
        t = a
        k = bisect.bisect_right(starts, t) - 1
        while t < b:
            if k >= 0 and k < len(segs) and t < segs[k][1]:
                hi, key = min(segs[k][1], b), segs[k][2]
            else:
                hi = min(starts[k + 1] if k + 1 < len(segs) else b, b)
                key = None
            out[key] = out.get(key, 0.0) + (hi - t) / 1e9
            t = hi
            k += 1
    return out


def idle_launching_pct(by_span):
    """Of the idle seconds by innermost span, the percent under a stage
    that enqueues device work (LAUNCHING)."""
    total = sum(by_span.values())
    if total <= 0:
        return None
    return 100.0 * sum(v for k, v in by_span.items()
                       if k in LAUNCHING) / total


def wavefront_graph_share(prog):
    """The intra wavefront steps replayed from a captured CUDA graph over
    all the steps taken (gpu.intra_pass.WAVEFRONT deltas)."""
    wf = prog["deltas"].get("wavefront", {})
    steps = wf.get("steps", 0)
    return wf.get("graph_steps", 0) / steps if steps else None


def p_chain_graph_share(prog):
    """The fused P chains replayed from a recorded script over all the P
    chains run (gpu.encode.PCHAIN deltas)."""
    pc = prog["deltas"].get("p_chain", {})
    runs = pc.get("runs", 0)
    return pc.get("graph_runs", 0) / runs if runs else None


def p_capture(prog) -> dict:
    """The P-chain scripts recorded ("p.capture" spans): how many, and
    their host milliseconds in all."""
    caps = [s for s in prog["spans"] if s["name"] == "p.capture"]
    return {"n": len(caps), "ms": sum(_ms(s["host_ns"]) or 0.0
                                      for s in caps)}


def program_metrics(tr: dict) -> dict:
    """The traced record's quantities (tr: record["trace"] with
    "program", "part1_ns", "idle_ns" and the stamps "stamps_ns")."""
    prog = tr["program"]
    by_span = idle_by_span(prog["spans"], tr["idle_ns"],
                           tr.get("stamps_ns", ()))
    return {
        "p_chain_launch_ms": p_chain_ms(prog, "host_ns"),
        "p_chain_device_ms": p_chain_ms(prog, "device_ns"),
        "lookahead_ms_per_frame": lookahead_ms_per_frame(prog),
        "host_wait_ms": host_wait_ms(prog, tr["part1_ns"]),
        "idle_launching_pct": idle_launching_pct(by_span),
        "wavefront_graph_share": wavefront_graph_share(prog),
        "p_chain_graph_share": p_chain_graph_share(prog),
        "p_capture": p_capture(prog),
        "idle_s": sum(by_span.values()),
        "idle_by_span": {str(k): v for k, v in sorted(
            by_span.items(), key=lambda kv: -kv[1])},
        "counters": prog["counters"], "deltas": prog["deltas"],
        "spans": len(prog["spans"]),
    }


def traced_run_class(harness):
    """harness.Run with the tracer and the two extra record keys."""
    from svt_hevc_tpu_torch import trace
    from yardstick import gaps_ns

    class TracedRun(harness.Run):
        last = None
        setup_capture = None

        def setup(self):
            # a tracer over the set-up too, for the P-chain recording
            # made there (p.capture)
            tr = trace.Tracer(self.device).start()
            try:
                super().setup()
            finally:
                prog = tr.stop()
            self.setup_capture = p_capture(prog)

        def _traced(self, genc):
            TracedRun.last = self
            tr = trace.Tracer(self.device).start()
            try:
                super()._traced(genc)
            finally:
                prog = tr.stop()
            self.record["trace"]["program"] = prog

        def _reduce(self, prof, launches, host_rows, h_mark, h0, h1):
            out = super()._reduce(prof, launches, host_rows, h_mark, h0, h1)
            events = harness._gpu_events(prof, self.device)
            marks = ([e for e in events if "spin_kernel" in e[0]]
                     or events[:1])
            off = marks[0][1] - h_mark
            lo, hi = h0 + off, h1 + off
            inside = [(ev[1], ev[2]) for ev in events
                      if ev is not marks[0] and ev[2] > lo and ev[1] < hi]
            out["part1_ns"] = [h0, h1]
            out["idle_ns"] = [[a - off, b - off]
                              for a, b in gaps_ns(inside, lo, hi)]
            out["stamps_ns"] = [r for r in host_rows
                                if r[0].startswith("bench.")]
            return out

    return TracedRun


def records_on_device(n: int = 1000) -> list:
    """The card's activities (name, count) torch.profiler records while
    the tracer opens and closes n spans around no work."""
    import harness
    from svt_hevc_tpu_torch import trace
    from torch.profiler import ProfilerActivity, profile
    prof = profile(activities=[ProfilerActivity.CUDA])
    tr = trace.Tracer("cuda").start()
    prof.start()
    try:
        for _ in range(n):
            with trace.span("p.empty"):
                pass
    finally:
        prof.stop()
        tr.stop()
    names: dict = {}
    for name, _, _ in harness._gpu_events(prof, "cuda"):
        names[name] = names.get(name, 0) + 1
    return sorted(names.items())


def on_cost(workload: str, seed: int, pairs: int, pictures: int) -> dict:
    """Pictures per second of blocks with the tracer off and on (order
    off, on, on, off, ...), after the cell's set-up, on the card."""
    import harness
    from svt_hevc_tpu_torch import trace
    device = "cuda"
    run = harness.Run(workload, seed, 0.0, False, T_START, device)
    run.setup()
    events = records_on_device()
    blocks = []
    for i in range(2 * pairs):
        on = (i % 4) in (1, 2)
        tr = trace.Tracer(device).start() if on else None
        if not on:
            run.sync()      # as start() does
        t0 = time.perf_counter()
        for _ in range(pictures):
            next(run.gen)
        dt = time.perf_counter() - t0
        spans = len(tr.stop()["spans"]) if on else 0
        blocks.append({"on": on, "fps": pictures / dt, "spans": spans})
    run.gen.close()
    off = [b["fps"] for b in blocks if not b["on"]]
    on_ = [b["fps"] for b in blocks if b["on"]]
    return {"records_device_events": events, "blocks": blocks,
            "median_fps_off": statistics.median(off),
            "median_fps_on": statistics.median(on_),
            "on_cost_pct": 100.0 * (1.0 - statistics.median(on_)
                                    / statistics.median(off))}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=40.0)
    ap.add_argument("--on-cost", type=int, default=0, metavar="PAIRS")
    ap.add_argument("--pictures", type=int, default=64)
    args = ap.parse_args(argv)
    import harness
    if args.on_cost:
        import torch
        torch.set_num_threads(1)
        out = on_cost(args.workload, args.seed, args.on_cost, args.pictures)
        print(json.dumps({"on_cost": out}), flush=True)
        return 0
    import run as bench_run
    harness.Run = traced_run_class(harness)
    rc = bench_run.main(["--workload", args.workload, "--seed",
                         str(args.seed), "--seconds", str(args.seconds),
                         "--trace", "1"])
    last = harness.Run.last
    if rc == 0 and last is not None:
        out = program_metrics(last.record["trace"])
        out["p_capture_setup"] = last.setup_capture
        print(json.dumps({"program": out}), flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
