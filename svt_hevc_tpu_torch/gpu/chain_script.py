"""Replay scripts of the fused P chain (gpu.encode.fast_p_fused_dev).

A script is the chain of one P picture recorded once and replayed for
every later P picture whose chain bakes in the same Python values: an
ordered list of entries of three kinds,

  ("graph", g)                 a CUDA graph segment, replayed;
  ("launch", kernel, args)     a K2 launch (kernels.MC_BLOCK) with the
                               arguments it was recorded with, made at
                               replay through kernel.launch, looked up at
                               each call, on the replaying stream;
  ("enter", name, wait), ("exit",)
                               gpu.encode.stage marks, entered and exited
                               at replay as the eager chain does.

K2 stays a Python call at replay so that everything that watches
MC_BLOCK.launch (its launch count, a hook on the attribute) sees each
launch as it does in the eager chain. Recording splits the chain at each
K2 launch and each stage mark; all segments of one script share one
memory pool, are captured in order and are replayed in that order.

A script reads its inputs from static buffers and writes its outputs to
static buffers: before a replay the caller's tensors are copied in,
after it the outputs are cloned out, so the next replay cannot
overwrite a picture still in use (the one-deep pipeline downloads a
picture after the next one is dispatched, and the device DPB keeps
reconstructions and motion).

Where a script applies is decided by what the chain observes, never by
a switch: CUDA tensors, and a chain without a host read (min_intra_log2
>= 6: the decision offers no intra CU, so _intra_fixup's any_intra read
never runs). Each encoder keeps one script (PChainScripts); a key seen on
two P pictures in a row is recorded, and replaces the kept script.
"""

from __future__ import annotations

import contextlib
import threading
import warnings

import torch

from .cublas import CUBLAS_LOCK, clear_cublas_workspaces

_ACTIVE = threading.local()


def recorder():
    """The recording under way on this thread, or None."""
    return getattr(_ACTIVE, "rec", None)


class Recorder:
    """Captures a chain as script entries: one CUDA graph segment between
    any two K2 launches or stage marks, all into one memory pool."""

    def __init__(self):
        self.entries: list[tuple] = []
        self._graph = None
        self.pool = None

    def begin(self) -> None:
        g = torch.cuda.CUDAGraph()
        # thread_local: CUDA calls of other threads (an EncoderHandle's
        # worker) do not invalidate the capture. The first segment makes
        # the pool; PyTorch captures into an existing pool only while a
        # live graph holds it, and the script keeps every segment
        g.capture_begin(pool=self.pool, capture_error_mode="thread_local")
        self._graph = g

    def cut(self) -> None:
        g, self._graph = self._graph, None
        g.capture_end()
        if self.pool is None:
            self.pool = g.pool()
        self.entries.append(("graph", g))

    def abort(self) -> None:
        """End a capture left open by an error."""
        g, self._graph = self._graph, None
        if g is not None:
            with contextlib.suppress(Exception):
                g.capture_end()

    def launch(self, kernel, args: tuple) -> None:
        """A kernel launch (its arguments without the stream) made between
        the segment before and the one after."""
        self.cut()
        self.entries.append(("launch", kernel, args))
        self.begin()

    @contextlib.contextmanager
    def mark(self, name: str, wait: bool = False):
        self.cut()
        self.entries.append(("enter", name, wait))
        self.begin()
        yield
        self.cut()
        self.entries.append(("exit",))
        self.begin()


def replay(entries, device: torch.device) -> None:
    """Walk a script's entries on the current stream of `device`."""
    from .encode import stage
    stream = torch.cuda.current_stream(device).cuda_stream
    open_ = []
    try:
        with torch.cuda.device(device):
            for e in entries:
                kind = e[0]
                if kind == "graph":
                    e[1].replay()
                elif kind == "launch":
                    e[1].launch(*e[2], stream)
                elif kind == "enter":
                    cm = stage(e[1], e[2])
                    cm.__enter__()
                    open_.append(cm)
                else:
                    open_.pop().__exit__(None, None, None)
    finally:
        while open_:
            open_.pop().__exit__(None, None, None)


def chain_key(src_y, qp: int, qp_c: int, lam: float, tb: int, td: int,
              col_none: bool, ctb_log2: int, w: int, h: int,
              bit_depth: int, dlf: bool, sao: bool, min_intra_log2: int,
              subpel_min: int):
    """Everything a recording of fast_p_fused_dev bakes in, or None where
    no script may serve the chain: tensors off the card, or a chain that
    reads a device value on the host (min_intra_log2 < 6)."""
    dev = src_y.device
    if dev.type != "cuda" or min_intra_log2 < 6:
        return None
    h64, w64 = src_y.shape
    return (str(dev), torch.cuda.current_stream(dev).cuda_stream, h64, w64,
            w, h, ctb_log2, bit_depth, qp, qp_c, lam, tb, td, col_none, dlf,
            sao, min_intra_log2, subpel_min)


class _Script:
    """A recorded chain, its static inputs and its static outputs."""

    def __init__(self, key, device, entries, pool, src, ref, hme, col,
                 outs):
        self.key, self.device, self.entries = key, device, entries
        self.pool = pool
        self.src, self.ref, self.hme, self.col = src, ref, hme, col
        self.outs = outs

    def load(self, src3, ref3, hme, col_mv, col_valid) -> None:
        for dst, t in zip((*self.src, *self.ref, self.hme, *self.col),
                          (*src3, *ref3, hme, col_mv, col_valid)):
            dst.copy_(t)

    def outputs(self) -> tuple:
        """Clones of the outputs, fast_p_fused_dev's tuple."""
        packed, rec_y, rec_cb, rec_cr, mv, valid, lv = self.outs
        return (packed.clone(), rec_y.clone(), rec_cb.clone(),
                rec_cr.clone(), mv.clone(), valid.clone(),
                tuple(t.clone() for t in lv))


class PChainScripts:
    """One encoder's kept P-chain script and the key of its last P
    picture. run() takes fast_p_fused_dev's arguments and returns its
    outputs: eagerly, by recording a script and replaying it, or by
    replaying the kept one."""

    def __init__(self):
        self.script: _Script | None = None
        self.last_key = None
        self._stream = None

    def plan(self, key) -> str:
        """"replay", "record" or "eager" for a chain with `key` (None: no
        script may serve it); remembers the key as the last one."""
        last, self.last_key = self.last_key, key
        if key is None:
            return "eager"
        if self.script is not None and self.script.key == key:
            return "replay"
        return "record" if key == last else "eager"

    def release(self) -> None:
        """Drop the kept script (its graphs, pool and static buffers)."""
        self.script = None
        self.last_key = None

    def run(self, src3, ref3, hme, qp: int, qp_c: int, lam: float, col_mv,
            col_valid, tb: int, td: int, *, col_none: bool, ctb_log2: int,
            w: int, h: int, bit_depth: int, dlf: bool, sao: bool,
            min_intra_log2: int, subpel_min: int):
        from . import encode as genc
        genc.PCHAIN["runs"] += 1
        kw = dict(ctb_log2=ctb_log2, w=w, h=h, bit_depth=bit_depth, dlf=dlf,
                  sao=sao, min_intra_log2=min_intra_log2,
                  subpel_min=subpel_min)
        key = chain_key(src3[0], qp, qp_c, lam, tb, td, col_none, **kw)
        action = self.plan(key)
        if action == "eager":
            return genc.fast_p_fused_dev(*src3, *ref3, hme, qp, qp_c, lam,
                                         col_mv, col_valid, tb, td, **kw)
        if action == "record":
            self.script = None
            self.script = self._record(key, src3, ref3, hme, col_mv,
                                       col_valid, (qp, qp_c, lam), (tb, td),
                                       kw)
        s = self.script
        s.load(src3, ref3, hme, col_mv, col_valid)
        replay(s.entries, s.device)
        genc.PCHAIN["graph_runs"] += 1
        return s.outputs()

    def _record(self, key, src3, ref3, hme, col_mv, col_valid, q, tbtd,
                kw) -> _Script:
        """Record the chain on a side stream (a graph cannot be captured
        on PyTorch's default stream) into a new script. The source and
        reference planes, HME field and collocated motion get static
        buffers of their own, which run()'s load fills."""
        from . import encode as genc
        dev = src3[0].device
        if self._stream is None or self._stream.device != dev:
            self._stream = torch.cuda.Stream(dev)
        stream = self._stream
        src = tuple(torch.empty_like(t) for t in src3)
        ref = tuple(torch.empty_like(t) for t in ref3)
        hme = torch.empty_like(hme)
        col = (torch.empty_like(col_mv), torch.empty_like(col_valid))
        rec = Recorder()
        with CUBLAS_LOCK, genc.stage("p.capture"):
            clear_cublas_workspaces()
            _ACTIVE.rec = rec
            try:
                with torch.cuda.stream(stream), warnings.catch_warnings():
                    # a segment between two adjacent marks holds no work
                    warnings.filterwarnings(
                        "ignore", message="The CUDA Graph is empty")
                    rec.begin()
                    outs = genc.fast_p_fused_dev(*src, *ref, hme, *q, *col,
                                                 *tbtd, **kw)
                    rec.cut()
            except BaseException:
                rec.abort()
                raise
            finally:
                _ACTIVE.rec = None
                clear_cublas_workspaces()
        genc.PCHAIN["captures"] += 1
        return _Script(key, dev, rec.entries, rec.pool, src, ref, hme, col,
                       outs)
