"""Streaming encoder API: the library surface of the port.

Port of svt_hevc_tpu/api.py. Pictures go in without blocking on the
encode, coded packets come out in decode order with pts/dts; one worker
thread drives Encoder.encode_pictures, whose device work is queued on
the card while the host walks the previous picture.

Usage:
    h = EncoderHandle(EncoderConfig(width=..., height=...))  # on "cuda"
    header = h.stream_header()
    for f in frames:
        h.send_picture(f)
    h.send_eos()
    while (pkt := h.get_packet()) is not None:
        out.write(pkt.data)
    h.close()

EncoderHandle(cfg, device="cpu") runs the same stages with the kernels'
plain PyTorch versions; without a device argument it needs a GPU and
raises where there is none.
"""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass

from .config import EncoderConfig
from .errors import EncoderError, ErrorCode, classify
from .io.yuv import Frame
from .pipeline.encoder import Encoder


@dataclass
class Packet:
    """One coded access unit."""

    data: bytes               # Annex-B bytes of the AU (slices + SEIs)
    pts: int                  # presentation index (input order)
    dts: int                  # decode index (emission order)
    slice_type: int           # 2 I, 1 P, 0 B
    is_idr: bool
    recon: Frame | None = None


class EncoderHandle:
    """Asynchronous encode channel: send_picture() enqueues without
    waiting for the encode; get_packet() dequeues coded AUs. A failed
    encode surfaces in the caller with its errors.ErrorCode."""

    def __init__(self, cfg: EncoderConfig, *, rd: bool | None = None,
                 device=None, input_depth: int = 48,
                 return_recon: bool = False):
        self.cfg = cfg.validate()
        self._enc = Encoder(cfg, device=device)
        self._rd = rd
        self._recon = return_recon
        self._in: queue.Queue = queue.Queue(maxsize=input_depth)
        self._out: queue.Queue = queue.Queue()
        self._err: BaseException | None = None
        self._err_code = None
        self._on_error = None
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()
        self._eos_sent = False

    # ------------------------------------------------------------- inputs
    def stream_header(self) -> bytes:
        """VPS/SPS/PPS (+ metadata SEI) bytes."""
        return self._enc.headers()

    def send_picture(self, frame: Frame) -> None:
        """Enqueue one picture; blocks only when the input queue is full.
        Oversized planes are rejected with an INPUT_FORMAT error code."""
        if frame.y is None or frame.y.shape[0] > self.cfg.height + 63 \
                or frame.y.shape[1] > self.cfg.width + 63:
            raise EncoderError(ErrorCode.INPUT_FORMAT,
                               "frame planes do not match configured "
                               f"dimensions {self.cfg.width}x"
                               f"{self.cfg.height}", "api")
        if self._eos_sent:
            raise RuntimeError("send_picture after EOS")
        self._raise_pending()
        self._in.put(frame)

    def send_eos(self) -> None:
        """Mark the end of the stream."""
        if not self._eos_sent:
            self._eos_sent = True
            self._in.put(None)

    # ------------------------------------------------------------ outputs
    def get_packet(self, timeout: float | None = None) -> Packet | None:
        """Next coded AU in decode order; None once the stream is done.
        Blocks until a packet (or the end of the stream) is available."""
        self._raise_pending()
        item = self._out.get(timeout=timeout)
        if isinstance(item, BaseException):
            raise item
        return item

    def packets(self):
        """Iterate all packets until the end of the stream."""
        while (pkt := self.get_packet()) is not None:
            yield pkt

    def close(self) -> None:
        self.send_eos()
        self._worker.join(timeout=600)

    # ------------------------------------------------------------- worker
    def _frames(self):
        while (fr := self._in.get()) is not None:
            yield fr

    def _run(self) -> None:
        try:
            for au in self._enc.encode_pictures(self._frames(),
                                                rd=self._rd):
                self._out.put(Packet(
                    data=au.data, pts=au.display_idx, dts=au.decode_idx,
                    slice_type=au.slice_type, is_idr=au.is_idr,
                    recon=au.recon if self._recon else None))
            self._out.put(None)
        except BaseException as e:              # surface in the caller
            self._err = e
            self._err_code = classify(e)
            if self._on_error is not None:
                try:
                    self._on_error(self._err_code, e)
                except Exception:
                    pass
            self._out.put(e)

    def _raise_pending(self) -> None:
        if self._err is not None:
            raise self._err

    @property
    def error_code(self):
        """ErrorCode of a failed encode (ErrorCode.OK if none)."""
        return self._err_code if self._err is not None else ErrorCode.OK

    def set_error_callback(self, fn) -> None:
        """Register fn(code: ErrorCode, exc), called from the worker when
        the encode fails."""
        self._on_error = fn
