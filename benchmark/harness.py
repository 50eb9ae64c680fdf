"""One run of one benchmark cell: set-up, the measured window, the check.

The cell names a configuration (configs/<config>.json) and a traffic mix
(traffic/<mix>.json); its metrics are BENCHMARK.json's entries that apply
to it, each computed by its reader, metrics/<name>.py, from the run's
record. Nothing here names a cell, a mix or a metric.

The window drives svt_hevc_tpu_torch's Encoder.encode_pictures, the loop
that the CLI and api.EncoderHandle run, with one stream of frames that the
encoder pulls as fast as it takes them (a closed loop of one client: an
offline file encode, or a live source faster than the encoder). The
feed is endless, so the program may hold at most HOLD_MAX frames pulled
and not yet yielded (Feed.i less the access units captured, checked at
each pull). A streaming encoder holds far fewer: two at a time where it
pipelines one picture deep, the VBR lookahead's refills of up to
2 (la + 1) frames (502 at the largest lookahead, 250), a mini-GOP of at
most 32, and two more in flight. A program that reads its feed to the
end before it yields would pull frames without end until the host runs
out of memory, and gives a live source nothing; past the bound the run
stops with HeldFeed, and nothing is measured or checked. Every run logs
the most frames it held. Set-up:
imports, the kernels' and the native emitter's libraries (built into the
checkout's build/ and native/ on a cell's first run there), the seeded
source, then the stream's first access unit (the IDR) and SETUP_P more.
The window then runs for `seconds` and ends at the first access unit
yielded at or after that time. Every access unit's reconstruction is
read back for the check as it is yielded (what the CLI's -o does): on the
card by a copy on a side stream into pinned host memory, ordered after
the encoder's queued work by an event, so that the host never waits for
it; its TMVP motion field is taken from the encoder's host-side record.
Where the window ends before the cell's quality range (cells/<cell>.json)
is whole, the encoder is pulled on, untimed, until every display index up
to the range's last has been yielded (pull_on).

With trace, the window has two parts. The first, of PROFILE_SECONDS,
runs under torch.profiler (CUDA activity only), with each K1 / K2
launch's dimensions recorded at its CudaKernel.launch and the program's
stages (gpu.encode.STAGE_TIMER) stamped on the host clock without any
synchronisation, to name the device's idle gaps. The second runs with
STAGE_TIMER synchronising around each stage, for the stage spans and the
intra wavefront's steps.

Imports torch and svt_hevc_tpu_torch inside the functions that need them.
"""

from __future__ import annotations

import contextlib
import importlib.util
import json
import os
import sys
import time

import numpy as np

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
SETUP_P = 2                 # P access units in set-up, after the IDR
PROFILE_SECONDS = 3.0       # the profiled part of a traced window
READBACK_CHUNK = 64         # pictures of pinned host memory per block
FORBIDDEN = ("jax", "jaxlib", "flax", "svt_hevc_tpu")
HOLD_MAX = 1024             # frames pulled and not yet yielded, at most


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def manifest() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def entry(entries: list, name: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"{name!r} is not in BENCHMARK.json")


def load_config(name: str) -> dict:
    with open(os.path.join(BENCH, "configs", f"{name}.json")) as f:
        return json.load(f)


def load_cell(name: str) -> dict:
    """cells/<cell>.json: the quality a cell's check holds its stream to
    (reference/quality.py), the faults that are its controls (faults.py,
    control.py), and jax_record, the length and sha256 of the JAX
    package's stream of seed 7's first pictures (tests)."""
    with open(os.path.join(BENCH, "cells", f"{name}.json")) as f:
        return json.load(f)


def encoder_config(conf: dict, dims=None):
    """The configuration file as the program runs it: the command line's
    tokens through the CLI's own parser ("cli"), or EncoderConfig's
    fields ("encoder"). dims (w, h) replaces the picture size (tests)."""
    from svt_hevc_tpu_torch import EncoderConfig, app
    if "cli" in conf:
        args = app.build_parser().parse_args(
            ["-i", "-", "-b", "-", *conf["cli"]])
        w, h = dims or (args.width, args.height)
        return app.config_from_args(args, w, h)
    kw = dict(conf["encoder"])
    if dims:
        kw.update(width=dims[0], height=dims[1])
    return EncoderConfig(**kw)


def expectations(cfg) -> dict:
    """What the stream must say, from the configuration (plain data for
    the reference)."""
    return {
        "width": cfg.width, "height": cfg.height,
        "bit_depth": cfg.bit_depth, "chroma_format": cfg.chroma_format,
        "ctb_size": cfg.ctb_size, "sao": cfg.enable_sao, "tmvp": cfg.tmvp,
        "deblocking": cfg.enable_deblocking,
        "tiles": [cfg.tile_columns, cfg.tile_rows],
        "pred_structure": cfg.pred_structure,
        "hierarchical_levels": cfg.hierarchical_levels,
        "intra_period": cfg.intra_period,
        "open_gop": (cfg.pred_structure == 2 and cfg.intra_period > 0
                     and cfg.intra_refresh_type == 1),
        "qp": cfg.qp if cfg.rate_control_mode == 0 else None,
        "qp_range": [cfg.min_qp_allowed, cfg.max_qp_allowed],
        "rc": (None if cfg.rate_control_mode == 0 or not cfg.target_bitrate
               or cfg.lookahead <= 0 else {
                   k: getattr(cfg, k) for k in (
                       "rate_control_mode", "fps_num", "fps_den",
                       "target_bitrate", "qp", "vbv_bufsize", "vbv_maxrate",
                       "min_qp_allowed", "max_qp_allowed", "lookahead")}),
    }


def reader(name: str):
    """metrics/<name>.py's read(record) -> number or None."""
    path = os.path.join(BENCH, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def metrics_of(man: dict, cell: str, trace: bool) -> list[dict]:
    """The cell's metrics: per_layer with trace, else end_to_end."""
    return [m for m in man["per_layer" if trace else "end_to_end"]
            if cell in m.get("workloads", [cell])]


class HeldFeed(RuntimeError):
    """The program held more than HOLD_MAX frames pulled and not yet
    yielded."""

    def __init__(self, held: int, yielded):
        super().__init__(
            f"the program held {held} frames pulled and not yet yielded "
            f"(bound {HOLD_MAX}); display indices yielded so far: "
            f"{index_ranges(yielded)}")


def index_ranges(indices) -> str:
    """Sorted indices as runs: "0-4, 8, 10-11"; "none" if there are none."""
    runs: list[list[int]] = []
    for i in sorted(indices):
        if runs and i == runs[-1][1] + 1:
            runs[-1][1] = i
        else:
            runs.append([i, i])
    return ", ".join(f"{a}-{b}" if b > a else f"{a}"
                     for a, b in runs) or "none"


class Feed:
    """The frames of a Source as Frame objects, made as the encoder pulls
    them; the pull time of each. run.stamps names the making. A pull that
    would leave the program holding more than HOLD_MAX frames pulled and
    not yet yielded raises HeldFeed; held_max is the most it held."""

    def __init__(self, source, run):
        from svt_hevc_tpu_torch.io.yuv import Frame
        self.frame_type = Frame
        self.source = source
        self.run = run
        self.pulled: dict[int, float] = {}
        self.i = 0
        self.held_max = 0

    def __iter__(self):
        return self

    def __next__(self):
        i = self.i
        self.i += 1
        held = self.i - len(self.run.pictures)
        if held > HOLD_MAX:
            raise HeldFeed(held, self.run.yielded)
        self.held_max = max(self.held_max, held)
        self.pulled[i] = time.perf_counter()
        with self.run.stamps.stage("bench.source"):
            y, cb, cr = self.source.frame(i)
        return self.frame_type(y=y, cb=cb, cr=cr)


class NoStages:
    @contextlib.contextmanager
    def stage(self, name):
        yield


class HostStages:
    """STAGE_TIMER that stamps each stage on the host clock (ns) and never
    synchronises."""

    def __init__(self):
        self.rows: list[tuple[str, int, int]] = []

    @contextlib.contextmanager
    def stage(self, name):
        t0 = time.perf_counter_ns()
        try:
            yield
        finally:
            self.rows.append((name, t0, time.perf_counter_ns()))


class SyncStages:
    """STAGE_TIMER that synchronises the card around each stage: its wall
    seconds hold the stage's device work."""

    def __init__(self, sync):
        self.sync = sync
        self.rows: list[tuple[str, float]] = []

    @contextlib.contextmanager
    def stage(self, name):
        self.sync()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.sync()
            self.rows.append((name, time.perf_counter() - t0))


class Readback:
    """Reconstructions read back from the card without stalling the host:
    at each yield an event on the encoder's stream, then on a side stream
    each plane cropped, cast to its display type and copied into pinned
    host memory, taken from blocks of READBACK_CHUNK pictures. The copies
    are final after finish()."""

    def __init__(self, plane_bytes: int):
        import torch
        self.torch = torch
        self.stream = torch.cuda.Stream()
        self.per = plane_bytes
        self.blocks: list = []
        self.used = 0
        self._grow()

    def _grow(self) -> None:
        self.blocks.append(self.torch.empty(
            self.per * READBACK_CHUNK, dtype=self.torch.uint8,
            pin_memory=True))
        self.used = 0

    def take(self, planes, dims, dtype) -> list:
        torch = self.torch
        if self.used + self.per > self.blocks[-1].numel():
            self._grow()
        ev = torch.cuda.Event()
        ev.record()
        out = []
        with torch.cuda.stream(self.stream):
            self.stream.wait_event(ev)
            for p, (h, w) in zip(planes, dims):
                src = p[:h, :w].to(dtype).contiguous()
                n = src.numel() * src.element_size()
                dst = self.blocks[-1][self.used:self.used + n].view(
                    dtype).view(h, w)
                dst.copy_(src, non_blocking=True)
                p.record_stream(self.stream)
                self.used += n
                out.append(dst)
        return out

    def finish(self) -> None:
        self.stream.synchronize()


def pull_on(pictures: list[dict], more, last: int) -> None:
    """Call more() (which appends one access unit to pictures) until every
    display index from 0 to last has been yielded. In decode order an
    anchor comes before the B pictures that display before it, so one
    index at or past last is not enough."""
    missing = set(range(last + 1)) - {p["idx"] for p in pictures}
    while missing:
        more()
        missing.discard(pictures[-1]["idx"])


def _gpu_events(prof, device: str) -> list[tuple[str, int, int]]:
    """(name, start ns, end ns) of every device activity in a profile (on
    the CPU, which the tests drive, of every host operation)."""
    out = []
    want = "CUDA" if device == "cuda" else "CPU"
    for e in prof.profiler.kineto_results.events():
        if want not in str(e.device_type()):
            continue
        if hasattr(e, "start_ns"):
            s, d = e.start_ns(), e.duration_ns()
        else:
            s, d = e.start_us() * 1000, e.duration_us() * 1000
        out.append((e.name(), int(s), int(s + d)))
    return out


def _stage_at(rows, t: int) -> str:
    """The innermost host stage open at host time t (ns)."""
    best = None
    for name, a, b in rows:
        if a <= t <= b and (best is None or a >= best[1]):
            best = (name, a)
    return best[0] if best else "host outside the program's stages"


class Run:
    """One run of one cell. device: "cuda" (the benchmark) or "cpu" (the
    tests, which drive the rest of a run without a card). dims: the
    picture size in place of the configuration's (tests)."""

    def __init__(self, cell: str, seed: int, seconds: float, trace: bool,
                 t_start: float, device: str = "cuda", dims=None):
        self.man = manifest()
        self.cell = entry(self.man["workloads"], cell)
        self.seed, self.seconds, self.trace = seed, seconds, trace
        self.t_start, self.device, self.dims = t_start, device, dims
        self.pictures: list[dict] = []
        self.motions: dict[int, dict] = {}
        self.yielded: dict[int, float] = {}
        self.record: dict = {}

    # ------------------------------------------------------------ helpers
    def sync(self) -> None:
        if self.device == "cuda":
            import torch
            torch.cuda.synchronize()

    def capture(self, au) -> float:
        """Take an access unit as it is yielded: its bytes, its
        reconstruction and its motion field. Returns the yield time."""
        now = time.perf_counter()
        with self.stamps.stage("bench.capture"):
            self.pictures.append({
                "idx": au.display_idx, "is_idr": bool(au.is_idr),
                "poc": int(au.poc), "data": au.data,
                "planes": self._planes(au.recon)})
            self.yielded[au.display_idx] = now
            ref = getattr(self.enc, "_ref_motion", None)
            if ref is None:         # the public, slower form
                ref = self.enc.checkpoint()["ref_motion"]
            if au.poc in ref:
                self.motions[au.display_idx] = ref[au.poc]
        return now

    def _planes(self, rec):
        """The reconstruction's three display planes: host arrays, or, for
        the card's lazily downloaded ones, pinned copies under way."""
        spec = getattr(rec, "__dict__", {}).get("_spec")
        dev = getattr(spec[0], "_dev", None) if spec else None
        if self.readback is None or dev is None:
            return (np.asarray(rec.y), np.asarray(rec.cb),
                    np.asarray(rec.cr))
        import torch
        _, w, h, wc, hc, dt = spec
        tdt = torch.uint8 if np.dtype(dt) == np.uint8 else torch.int16
        return self.readback.take(dev, ((h, w), (hc, wc), (hc, wc)), tdt)

    def _host_planes(self) -> None:
        """Once the copies are final, every picture's planes as arrays."""
        if self.readback is not None:
            self.readback.finish()
        dt = np.uint8 if self.cfg.bit_depth == 8 else np.uint16
        for p in self.pictures:
            p["planes"] = tuple(
                x.numpy().view(dt) if hasattr(x, "numpy") else x
                for x in p["planes"])

    # ------------------------------------------------------------ phases
    def setup(self) -> None:
        from svt_hevc_tpu_torch import Encoder
        from svt_hevc_tpu_torch.pipeline.native_emit import (
            native_emit_available)
        from frames import Source, load_mix
        if self.device == "cuda":
            import torch
            from svt_hevc_tpu_torch.gpu import kernels
            todo = [k for k in kernels.KERNELS if k.stale()]
            if todo:
                log(f"building {[k.name for k in todo]}: "
                    f"{kernels.build_all(todo):.1f} s")
        if not native_emit_available():
            raise RuntimeError("the native host emitter (native/*.c) did "
                               "not build: the Python emitter is not what "
                               "is measured")
        self.cfg = encoder_config(load_config(self.cell["config"]),
                                  self.dims)
        self.source = Source(load_mix(self.cell["traffic"]), self.cfg.width,
                             self.cfg.height, self.cfg.bit_depth, self.seed)
        self.quality = load_cell(self.cell["name"])["quality"]
        self.stamps = NoStages()
        self.feed = Feed(self.source, self)
        self.readback = None
        if self.device == "cuda":
            size = 1 if self.cfg.bit_depth == 8 else 2
            self.readback = Readback(size * (self.cfg.width * self.cfg.height
                                             * 3 // 2))
            torch.cuda.reset_peak_memory_stats()
        self.enc = Encoder(self.cfg, device=self.device)
        self.gen = self.enc.encode_pictures(self.feed)
        for _ in range(1 + SETUP_P):
            self.capture(next(self.gen))
        self.t0 = time.perf_counter()
        self.record["setup_s"] = self.t0 - self.t_start
        log(f"set-up {self.record['setup_s']:.3f} s: {self.cfg.width}x"
            f"{self.cfg.height}, {len(self.pictures)} access units")

    def window(self) -> None:
        from svt_hevc_tpu_torch.gpu import encode as genc
        first = len(self.pictures)
        try:
            if self.trace:
                self._traced(genc)
            else:
                end = self.t0 + self.seconds
                now = self.t0
                while now < end:
                    now = self.capture(next(self.gen))
        finally:
            genc.STAGE_TIMER = None
        t_end = self.yielded[self.pictures[-1]["idx"]]
        win = self.pictures[first:]
        pull_on(self.pictures, lambda: self.capture(next(self.gen)),
                self.quality["first"] + self.quality["count"] - 1)
        self.gen.close()
        self.sync()
        self._host_planes()
        pulled = self.feed.pulled
        self.record.update({
            "window_s": t_end - self.t0,
            "window_aus": len(win),
            "window_idx": [p["idx"] for p in win],
            "idrs_in_window": sum(p["is_idr"] for p in win),
            "latencies_s": [self.yielded[p["idx"]] - pulled[p["idx"]]
                            for p in win if pulled[p["idx"]] > self.t0],
        })
        if self.device == "cuda":
            import torch
            self.record["peak_bytes"] = torch.cuda.max_memory_allocated()
        log(f"window {self.record['window_s']:.3f} s: "
            f"{len(win)} access units, "
            f"{self.record['idrs_in_window']} IDRs in the window")
        log(f"held at most {self.feed.held_max} frames pulled and not yet "
            f"yielded (bound {HOLD_MAX})")

    def _traced(self, genc) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile
        from svt_hevc_tpu_torch.gpu import intra_pass, kernels
        # part 1: the profiler, launch dimensions, host stage stamps
        launches = {"sad_field": [], "mc_block": []}
        orig = {}
        for k in (kernels.SAD_FIELD, kernels.MC_BLOCK):
            orig[k.name] = k.launch

            def hook(*args, _k=k):
                launches[_k.name].append(tuple(
                    int(a) if isinstance(a, int) else None for a in args))
                return orig[_k.name](*args)
            k.launch = hook
        host = HostStages()
        self.stamps = host
        genc.STAGE_TIMER = host
        self.sync()
        cuda = self.device == "cuda"
        prof = profile(activities=[ProfilerActivity.CUDA if cuda
                                   else ProfilerActivity.CPU])
        prof.start()        # the profiler's start takes seconds: before t0
        try:
            self.sync()
            h_mark = time.perf_counter_ns()
            if cuda:
                torch.cuda._sleep(1000)
            self.sync()
            h0 = time.perf_counter_ns()
            now = self.t0 = time.perf_counter()
            end = self.t0 + self.seconds
            part1 = min(self.t0 + PROFILE_SECONDS, end)
            while now < part1:
                now = self.capture(next(self.gen))
            h1 = time.perf_counter_ns()
            self.sync()
        finally:
            prof.stop()
            for k in (kernels.SAD_FIELD, kernels.MC_BLOCK):
                del k.launch
        # part 2: the synchronised stage spans and wavefront steps
        spans = SyncStages(self.sync)
        self.stamps = NoStages()
        genc.STAGE_TIMER = spans
        steps0 = intra_pass.WAVEFRONT["steps"]
        while now < end:
            now = self.capture(next(self.gen))
        steps = intra_pass.WAVEFRONT["steps"] - steps0
        genc.STAGE_TIMER = None
        self.record["trace"] = self._reduce(prof, launches, host.rows,
                                            h_mark, h0, h1)
        self.record["trace"].update({"spans": spans.rows,
                                     "wavefront_steps": steps})

    def _reduce(self, prof, launches, host_rows, h_mark, h0, h1) -> dict:
        from yardstick import gaps_ns, union_ns
        events = _gpu_events(prof, self.device)
        marks = [e for e in events if "spin_kernel" in e[0]] or events[:1]
        off = marks[0][1] - h_mark          # trace clock - host clock
        events = [e for e in events if e is not marks[0]]
        lo, hi = h0 + off, h1 + off
        inside = [(s, e) for _, s, e in events if e > lo and s < hi]
        busy = union_ns(inside, lo, hi)
        by_name: dict[str, float] = {}
        for name, s, e in events:
            if e > lo and s < hi:
                short = name[:120]      # C++ template names run long
                by_name[short] = by_name.get(short, 0.0) + (e - s) / 1e9
        gaps = sorted(gaps_ns(inside, lo, hi), key=lambda g: g[0] - g[1])
        idle = [[_stage_at(host_rows, (a + b) // 2 - off), (b - a) / 1e9]
                for a, b in gaps[:10]]
        kern = {}
        for name in launches:
            evs = sorted((s, e) for n, s, e in events if f"{name}_kernel" in n)
            kern[name] = {"launches": launches[name],
                          "seconds": [(e - s) / 1e9 for s, e in evs]}
        return {
            "window_s": (h1 - h0) / 1e9, "busy_s": busy / 1e9,
            "kernels": kern,
            "breakdown": {
                "device_ops": sorted(([n, t] for n, t in by_name.items()),
                                     key=lambda r: -r[1])[:10],
                "idle_gaps": idle},
        }

    def check(self) -> dict:
        from reference.check import check_stream
        from reference.quality import quality
        ex = expectations(self.cfg)
        params = self.enc.headers()
        pulled = self.feed.i
        del self.enc, self.gen, self.feed
        if self.device == "cuda":
            import torch
            torch.cuda.empty_cache()
        lumas = None
        if ex["rc"]:        # the same source frames, made again
            lumas = (self.source.frame(i)[0] for i in range(pulled))
        verdict = check_stream(params, self.pictures, self.motions, ex,
                               lumas=lumas)
        verdict["quality"] = quality(
            {p["idx"]: p for p in self.pictures},
            lambda i: self.source.frame(i)[0], self.cfg.bit_depth,
            self.quality)
        return verdict


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def execute(cell: str, seed: int, seconds: float, trace: bool,
            t_start: float, device: str = "cuda", dims=None) -> dict:
    """Set up, measure, check; the result line as a dict."""
    run = Run(cell, seed, seconds, trace, t_start, device, dims)
    run.setup()
    run.window()
    t = time.perf_counter()
    try:
        verdict = run.check()
    except Exception as e:          # the check itself failed: not correct
        verdict = {"pictures_planned": len(run.pictures),
                   "pictures_checked": 0,
                   "pictures_wrong": len(run.pictures),
                   "wrong_idx": [p["idx"] for p in run.pictures],
                   "quality": {"rate_loss_pct": None},
                   "faults": [f"check failed: {type(e).__name__}: {e}"]}
    log(f"check {time.perf_counter() - t:.1f} s: chunks "
        f"{verdict.get('chunks')}, worker seconds "
        f"{[round(s, 1) for s in verdict.get('worker_seconds', [])]}")
    for f in verdict["faults"]:
        log(f"fault: {f}")
    q = verdict["quality"]
    if "bytes" in q:
        log(f"quality over pictures {run.quality['first']}.."
            f"{run.quality['first'] + run.quality['count'] - 1}: "
            f"{q['bytes']} bytes, PSNR-Y {q['psnr_y_db']!r} dB")
    rec = run.record
    metrics = {}
    for m in metrics_of(run.man, cell, trace):
        v = reader(m["name"])(rec)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    checks = {
        "pictures_wrong": {"value": verdict["pictures_wrong"], "limit": 0},
        "pictures_unchecked": {
            "value": verdict["pictures_planned"]
            - verdict["pictures_checked"], "limit": 0},
        "rate_loss_pct": {"value": verdict["quality"]["rate_loss_pct"],
                          "limit": run.quality["limit_rate_loss_pct"]},
    }
    correct = all(c["value"] is not None and c["value"] <= c["limit"]
                  for c in checks.values())
    device = {"platform": "cpu", "kind": "cpu", "count": 1,
              "memory_peak_bytes": 0}
    if run.device == "cuda":
        import torch
        device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                  "count": run.cell["chips"],
                  "memory_peak_bytes": rec["peak_bytes"]}
        device.update(card_limits())
    wrong = set(verdict["wrong_idx"])
    out = {"correct": correct, "attempted": rec["window_aus"],
           "failed": sum(1 for i in rec["window_idx"] if i in wrong),
           "metrics": metrics, "device": device}
    if trace:
        tr = rec["trace"]
        device.update(busy_s=tr["busy_s"], window_s=tr["window_s"])
        out["breakdown"] = tr["breakdown"]
    out["checks"] = checks
    for name, c in checks.items():
        log(f"check {name} {c['value']} limit {c['limit']}")
    return out


def children() -> list[int]:
    """Process ids whose parent is this process (Linux's /proc)."""
    me, out = os.getpid(), []
    try:
        pids = [d for d in os.listdir("/proc") if d.isdigit()]
    except OSError:
        return out
    for d in pids:
        try:
            with open(f"/proc/{d}/stat") as f:
                ppid = int(f.read().rsplit(")", 1)[1].split()[1])
        except (OSError, IndexError, ValueError):
            continue
        if ppid == me:
            out.append(int(d))
    return out


def stop_children(grace: float = 10.0) -> list[int]:
    """Stop every process this run started and wait until each has ended.
    The check's spawned pool leaves multiprocessing's resource tracker
    running (it ignores SIGTERM and ends when the pipe it reads is
    closed), so it is stopped first; any other child gets `grace` seconds,
    then SIGKILL, and is reaped. Returns the ids that were still running
    after the tracker was stopped."""
    import signal
    from multiprocessing import resource_tracker as rt
    tracker = rt._resource_tracker
    if getattr(tracker, "_pid", None) is not None:
        if hasattr(tracker, "_stop"):
            tracker._stop()
        else:               # before _stop: close its pipe, then reap it
            os.close(tracker._fd)
            os.waitpid(tracker._pid, 0)
            tracker._fd = tracker._pid = None
    left = children()
    end = time.monotonic() + grace
    for pid in left:
        while True:
            try:
                done, _ = os.waitpid(pid, os.WNOHANG)
            except ChildProcessError:
                break
            if done:
                break
            if time.monotonic() > end:
                with contextlib.suppress(ProcessLookupError):
                    os.kill(pid, signal.SIGKILL)
                with contextlib.suppress(ChildProcessError):
                    os.waitpid(pid, 0)
                break
            time.sleep(0.05)
    return left


def card_limits() -> dict:
    """The card's power limit as nvidia-smi reads it (the peaks the
    rooflines use hold at 700 W)."""
    import subprocess
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, timeout=30)
        return {"power_limit_w": float(smi.stdout.split()[0])}
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return {"power_limit_w": None}
