"""The encoder's tracer: named spans and counters, in memory, off by default.

Switched on from Python only (no environment variable, no flag):

    from svt_hevc_tpu_torch import trace
    tr = trace.Tracer("cuda").start()
    for au in encoder.encode_pictures(frames):
        ...
    out = tr.stop()

While a Tracer runs, every span the program opens is recorded with

  name      the stage ("p.dense_md_p", "pic.dispatch", "wait.download", ...)
  pic       the display index of the picture whose work it is (None for
            stream-level work: pulling frames, the lookahead)
  parent    the index in out["spans"] of the span that encloses it, or None
  wait      True where the host blocks on the device (a read of a device
            result): "wait.download", "wait.lookahead", "p.any_intra",
            "b.any_intra". Readers find waits by this flag.
  host_ns   [start, end] on time.perf_counter_ns()
  device_ns [start, end] on the same clock, from two CUDA events recorded
            on the current stream at the span's start and end (when the
            device reached the span's first and last queued work); None on
            the CPU

Nothing is synchronised while it runs: the events are read in stop(),
which synchronises once and places them on the host clock through an
anchor event that start() records on an idle device. stop() returns
plain data: {"device", "spans", "counters" (the program's own, e.g.
"la.frames"), "deltas" (over the traced interval, of the counters the
program already keeps: every CudaKernel's launches,
gpu.intra_pass.WAVEFRONT and gpu.encode.PCHAIN)}.

While no Tracer runs, span() and picture() return one shared
nullcontext after reading a global, and count() returns at once.
Spans are kept until stop(); trace bounded intervals.
"""

from __future__ import annotations

import contextlib
import threading
import time

_NULL = contextlib.nullcontext()
_ACTIVE: Tracer | None = None


def span(name: str, wait: bool = False):
    """Context of one named span of the running tracer (a no-op when none
    runs). wait: the host blocks on the device inside it."""
    t = _ACTIVE
    return _NULL if t is None else _Span(t, name, wait)


def picture(idx):
    """Context under which new spans carry the picture idx (display
    index)."""
    t = _ACTIVE
    return _NULL if t is None else _Picture(t._local, idx)


def current_picture():
    """The picture that new spans would carry now (None when no tracer
    runs)."""
    t = _ACTIVE
    return None if t is None else getattr(t._local, "pic", None)


def count(name: str, n: int = 1) -> None:
    """Add n to the running tracer's counter name."""
    t = _ACTIVE
    if t is not None:
        with t._lock:
            t.counters[name] = t.counters.get(name, 0) + n


def existing_counters() -> dict:
    """The counters the program keeps whether or not a tracer runs:
    {"launches": {kernel: n}, "wavefront": {"runs": n, "steps": n,
    "graph_steps": n, "captures": n}, "p_chain": {"runs": n,
    "graph_runs": n, "captures": n}} (graph_steps: the wavefront steps
    replayed from a captured CUDA graph; captures: the graphs captured,
    each inside a "wf.capture" span; graph_runs: the fused P chains
    replayed from a recorded script; p_chain captures: the scripts
    recorded, each inside a "p.capture" span)."""
    from .gpu import encode, intra_pass, kernels
    return {"launches": {k.name: k.launches for k in kernels.KERNELS},
            "wavefront": dict(intra_pass.WAVEFRONT),
            "p_chain": dict(encode.PCHAIN)}


class _Span:
    __slots__ = ("tr", "name", "wait", "row")

    def __init__(self, tr, name, wait):
        self.tr, self.name, self.wait = tr, name, wait

    def __enter__(self):
        tr = self.tr
        loc = tr._local
        stack = loc.__dict__.setdefault("stack", [])
        # [name, pic, parent row, wait, host start, host end, ev0, ev1]
        row = [self.name, getattr(loc, "pic", None),
               stack[-1] if stack else None, self.wait,
               time.perf_counter_ns(), None, None, None]
        if tr.cuda:
            row[6] = tr._event()
        tr.rows.append(row)
        stack.append(row)
        self.row = row

    def __exit__(self, *exc):
        row = self.row
        if self.tr.cuda:
            row[7] = self.tr._event()
        row[5] = time.perf_counter_ns()
        self.tr._local.stack.pop()
        return False


class _Picture:
    __slots__ = ("loc", "idx", "prev")

    def __init__(self, loc, idx):
        self.loc, self.idx = loc, idx

    def __enter__(self):
        self.prev = getattr(self.loc, "pic", None)
        self.loc.pic = self.idx

    def __exit__(self, *exc):
        self.loc.pic = self.prev
        return False


class Tracer:
    """Records the program's spans and counters between start() and
    stop(). device: the device the encoder runs on; on a CUDA device each
    span also records two events on its current stream."""

    def __init__(self, device):
        import torch
        self.torch = torch
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self.rows: list[list] = []
        self.counters: dict[str, int] = {}
        self._local = threading.local()
        self._lock = threading.Lock()
        self._base: dict = {}
        self._anchor = None
        self._anchor_ns = 0

    def _event(self):
        ev = self.torch.cuda.Event(enable_timing=True)
        ev.record(self.torch.cuda.current_stream(self.device))
        return ev

    def start(self) -> Tracer:
        """Start recording (one tracer at a time). On CUDA, synchronises
        the device once and records the anchor event on it."""
        global _ACTIVE
        if _ACTIVE is not None:
            raise RuntimeError("a Tracer is already running")
        self._base = existing_counters()
        if self.cuda:
            cuda = self.torch.cuda
            cuda.synchronize(self.device)
            t0 = time.perf_counter_ns()
            self._anchor = self._event()
            self._anchor_ns = (t0 + time.perf_counter_ns()) // 2
            cuda.synchronize(self.device)
        _ACTIVE = self
        return self

    def stop(self) -> dict:
        """Stop recording; synchronise once (on CUDA) and return the
        spans, counters and counter deltas as plain data."""
        global _ACTIVE
        if _ACTIVE is self:
            _ACTIVE = None
        if self.cuda:
            self.torch.cuda.synchronize(self.device)
        index = {id(r): i for i, r in enumerate(self.rows)}
        spans = []
        for name, pic, parent, wait, h0, h1, ev0, ev1 in self.rows:
            dev = None
            if ev0 is not None and ev1 is not None:
                dev = [self._on_host(ev0), self._on_host(ev1)]
            spans.append({"name": name, "pic": pic,
                          "parent": None if parent is None
                          else index[id(parent)],
                          "wait": wait, "host_ns": [h0, h1],
                          "device_ns": dev})
        now = existing_counters()
        deltas = {group: {k: v - self._base[group].get(k, 0)
                          for k, v in vals.items()}
                  for group, vals in now.items()}
        self.rows = []
        return {"device": str(self.device), "spans": spans,
                "counters": dict(self.counters), "deltas": deltas}

    def _on_host(self, ev) -> int:
        """An event's time on the host clock (ns)."""
        return self._anchor_ns + round(self._anchor.elapsed_time(ev) * 1e6)

