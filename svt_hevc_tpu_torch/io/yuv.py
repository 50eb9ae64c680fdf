"""Raw YUV / Y4M frame I/O.

Analogue of the reference CLI's readers (reference: Source/App/EbAppProcessCmd.c
ReadInputFrames and Source/App/EbAppInputy4m.c), numpy-based.
"""

from __future__ import annotations

import io
from dataclasses import dataclass
from typing import Iterator, BinaryIO

import numpy as np


@dataclass
class Frame:
    """One planar YUV frame. y: (H, W); cb/cr: (H/2, W/2) for 4:2:0,
    (H, W/2) for 4:2:2, (H, W) for 4:4:4."""
    y: np.ndarray
    cb: np.ndarray
    cr: np.ndarray
    # optional per-picture metadata (reference: per-input-buffer SEI/RPU
    # attachments, EbApi.h EB_SEI_MESSAGE dolbyVisionRpu / user data)
    dv_rpu: bytes | None = None        # Dolby Vision RPU (emitted as NAL 62)
    sei_t35: bytes | None = None       # registered user data (ITU-T T.35)
    sei_unreg: tuple | None = None     # (uuid16: bytes, data: bytes)
    segment_ov: np.ndarray | None = None
                                       # (n_ctb_y, n_ctb_x, 3) per-CTB
                                       # [flags, qp_ov, deblock_ov] override
                                       # (reference SegmentOverride_t,
                                       # EbApi.h:44-68)

    @property
    def width(self) -> int:
        return self.y.shape[1]

    @property
    def height(self) -> int:
        return self.y.shape[0]

    @property
    def peak(self) -> float:
        return 255.0 if self.y.dtype == np.uint8 else 1023.0

    def psnr(self, other: "Frame") -> tuple[float, float, float]:
        out = []
        for a, b in ((self.y, other.y), (self.cb, other.cb), (self.cr, other.cr)):
            mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
            out.append(99.0 if mse == 0 else 10.0 * np.log10(self.peak ** 2 / mse))
        return tuple(out)  # type: ignore[return-value]


def read_yuv(f: BinaryIO | str, width: int, height: int,
             max_frames: int | None = None, bit_depth: int = 8,
             chroma_format: int = 1) -> Iterator[Frame]:
    """Iterate planar YUV frames (P420/P422/P444) from a raw file. 10-bit
    input uses 2 bytes/sample little-endian (the reference's "unpacked"
    mode, EbApi.h compressedTenBitFormat=0)."""
    close = False
    if isinstance(f, str):
        f = open(f, "rb")
        close = True
    dt = np.uint8 if bit_depth == 8 else np.dtype("<u2")
    bps = np.dtype(dt).itemsize
    cw = width // (2 if chroma_format in (1, 2) else 1)
    ch = height // (2 if chroma_format == 1 else 1)
    try:
        ysz, csz = width * height, cw * ch
        nbytes = (ysz + 2 * csz) * bps
        n = 0
        while max_frames is None or n < max_frames:
            buf = f.read(nbytes)
            if len(buf) < nbytes:
                return
            y = np.frombuffer(buf, dt, ysz).reshape(height, width)
            cb = np.frombuffer(buf, dt, csz, ysz * bps).reshape(ch, cw)
            cr = np.frombuffer(buf, dt, csz, (ysz + csz) * bps).reshape(ch, cw)
            yield Frame(y.copy(), cb.copy(), cr.copy())
            n += 1
    finally:
        if close:
            f.close()


def read_yuv420(f: BinaryIO | str, width: int, height: int,
                max_frames: int | None = None,
                bit_depth: int = 8) -> Iterator[Frame]:
    """Iterate planar 4:2:0 frames from a raw YUV file."""
    yield from read_yuv(f, width, height, max_frames, bit_depth, 1)


def write_yuv420(f: BinaryIO | str, frames) -> None:
    close = False
    if isinstance(f, str):
        f = open(f, "wb")
        close = True
    try:
        for fr in frames:
            dt = np.uint8 if fr.y.dtype == np.uint8 else np.dtype("<u2")
            f.write(fr.y.astype(dt).tobytes())
            f.write(fr.cb.astype(dt).tobytes())
            f.write(fr.cr.astype(dt).tobytes())
    finally:
        if close:
            f.close()


def read_y4m(f: BinaryIO | str, max_frames: int | None = None) -> Iterator[Frame]:
    """Iterate frames from a Y4M container (C420 / C422 / C444, 8-bit).

    Header parsing mirrors the reference's Y4M reader
    (Source/App/EbAppInputy4m.c) without the interlacing/aspect plumbing.
    """
    close = False
    if isinstance(f, str):
        f = open(f, "rb")
        close = True
    try:
        header = bytearray()
        while not header.endswith(b"\n"):
            c = f.read(1)
            if not c:
                raise ValueError("truncated y4m header")
            header += c
        fields = header.decode().split()
        if fields[0] != "YUV4MPEG2":
            raise ValueError("not a y4m stream")
        width = height = 0
        chroma_format = 1
        for tok in fields[1:]:
            if tok[0] == "W":
                width = int(tok[1:])
            elif tok[0] == "H":
                height = int(tok[1:])
            elif tok[0] == "C":
                cs = tok[1:]
                if cs.startswith("420"):
                    chroma_format = 1
                elif cs.startswith("422"):
                    chroma_format = 2
                elif cs.startswith("444"):
                    chroma_format = 3
                else:
                    raise NotImplementedError(
                        f"y4m chroma format {tok} unsupported")
        if not width or not height:
            raise ValueError("y4m header missing W/H")
        n = 0
        while max_frames is None or n < max_frames:
            line = bytearray()
            c = f.read(1)
            if not c:
                return
            line += c
            while not line.endswith(b"\n"):
                c = f.read(1)
                if not c:
                    return
                line += c
            if not line.startswith(b"FRAME"):
                raise ValueError("bad y4m frame marker")
            frames = read_yuv(f, width, height, max_frames=1,
                              chroma_format=chroma_format)
            fr = next(iter(frames), None)
            if fr is None:
                return
            yield fr
            n += 1
    finally:
        if close:
            f.close()
