"""Per-frame rate/PSNR trace of one or more Annex-B streams against a
YUV source: frame sizes from the NAL stream, per-frame luma PSNR from
the decode. Localizes WHERE two encoders' bits/quality diverge (I vs P,
early vs late in the GOP, drift).

    python3 tools/torch_frame_trace.py STREAM.265 [...] --clip SRC.yuv
                                       [--width W --height H]
                                       [--decoder port|de265]

--decoder: the port's own decoder (default) or libde265 through the
port's binding, which raises where the library is not installed
(torch_compare_reference.decode_luma). The twin of tools/frame_trace.py;
it imports nothing of the JAX package.
"""

from __future__ import annotations

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402

from torch_compare_reference import decode_luma  # noqa: E402


def nal_units(data: bytes):
    i = 0
    starts = []
    while True:
        j = data.find(b"\x00\x00\x01", i)
        if j < 0:
            break
        starts.append(j)
        i = j + 3
    for a, b in zip(starts, starts[1:] + [len(data)]):
        off = a + 3
        yield data[off:b]


def frame_sizes(data: bytes):
    """Bytes per access unit (VCL NAL + preceding non-VCL)."""
    sizes = []
    acc = 0
    for nal in nal_units(data):
        t = (nal[0] >> 1) & 0x3F
        acc += len(nal) + 3
        if t <= 31:          # VCL
            sizes.append(acc)
            acc = 0
    if acc:
        sizes[-1] += acc
    return sizes


def trace(path: str, src_frames, decoder: str = "port"):
    """(frame, bytes, PSNR-Y) per decoded picture of the stream file."""
    with open(path, "rb") as f:
        data = f.read()
    dec = decode_luma(data, decoder)
    sizes = frame_sizes(data)
    rows = []
    for i, dy in enumerate(dec):
        sy = src_frames[i][0]
        mse = float(((dy.astype(np.float64) - sy) ** 2).mean())
        rows.append((i, sizes[i] if i < len(sizes) else -1,
                     10 * np.log10(255 ** 2 / max(mse, 1e-12))))
    return rows


def main():
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("streams", nargs="+")
    ap.add_argument("--width", type=int, default=352)
    ap.add_argument("--height", type=int, default=288)
    ap.add_argument("--clip", required=True)
    ap.add_argument("--decoder", choices=("port", "de265"), default="port")
    args = ap.parse_args()
    w, h = args.width, args.height
    with open(args.clip, "rb") as f:
        raw = f.read()
    fsz = w * h * 3 // 2
    n = len(raw) // fsz
    src = []
    for i in range(n):
        y = np.frombuffer(raw, np.uint8, w * h, i * fsz).reshape(h, w)
        src.append((y.astype(np.int64), None, None))
    traces = [trace(p, src, args.decoder) for p in args.streams]
    hdr = "".join(f"{os.path.basename(p):>24}" for p in args.streams)
    print(f"{'frame':>5}" + hdr)
    for i in range(len(traces[0])):
        row = f"{i:>5}"
        for t in traces:
            row += f"{t[i][1]:>12}B {t[i][2]:>8.2f}dB"[:24].rjust(24)
        print(row)
    for p, t in zip(args.streams, traces):
        tot = sum(r[1] for r in t)
        print(f"{p}: total {tot}B  I={t[0][1]}B  "
              f"avgP={np.mean([r[1] for r in t[1:]]):.0f}B  "
              f"avgPSNR={np.mean([r[2] for r in t]):.2f}")


if __name__ == "__main__":
    main()
