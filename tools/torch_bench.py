"""Benchmark of the PyTorch/CUDA port: full encode throughput at 1080p, M7,
IPPP, on one GPU.

    python3 tools/torch_bench.py [--device cuda|cpu]
    python3 tools/torch_bench.py --gpu-cpu-check

Times Encoder.encode_pictures() end to end (upload, HME, mode decision,
encode pass, DLF / SAO, download, the native host emitter and CABAC) on
bench.py's configuration: 1920x1080, make_frames(seed=7), M7, qp 32,
50 fps, IPPP (intra_period=-1), up to MAX_FRAMES frames. The clock is the
host's, read between yielded access units, as in bench.py:

- idr_seconds: from the start to the first access unit. The encoder
  pipelines CQP low-delay pictures one deep, so frames 0 and 1 are both
  dispatched before access unit 0 is yielded: idr_seconds holds the IDR
  and the first P picture's dispatch, as bench.py's does.
- compile_seconds: access unit 1's wall time, the first P picture. There
  is no graph compile here: the CUDA kernels (gpu/kernels.build_all) and
  the native emitter are built before the clock starts, and their build
  seconds are printed on an earlier line. A run fails (nonzero exit)
  where the native emitter did not build, since the Python emitter is
  not what is timed.
- value: steady-state frames per second over the access units after the
  WARMUP_FRAMES first, within a TIME_BUDGET_S window; vs_baseline is it
  over 50 fps (1080p50 real time).

torch.cuda.synchronize() runs before the clock starts and after the last
access unit; each yielded access unit waits for its own download, so the
yields are synchronous anyway. Leaving encode_pictures at the window's
end leaves one picture in flight; the joined stream of the yielded
access units must still decode.

The stream is then decoded and compared plane for plane with the
encoder's reconstruction, with PSNR-Y against the source: by libde265
where the port's binding finds the library, else by the port's own
decoder; "decoder" in the line names which. Decode seconds are printed
on an earlier line.

Prints ONE JSON line, last, always: on SIGTERM, SIGINT and SIGALRM, and
at the DEADLINE_S alarm (re-armed for the decode), with the phase
reached and "/sig<N>" after it. Python runs a signal handler only between
bytecodes, so a signal that arrives inside a long CUDA synchronize (or
any long call into the C++ runtime) is handled when that call returns.
Keys: bench.py's (metric, value, unit, vs_baseline, idr_seconds,
compile_seconds, steady_frames, decode_ok, psnr_y, phase) plus device
({platform, name, power_limit_w, count}; on the card name and power limit
from nvidia-smi) and decoder ("libde265" or "port").

--device: cuda (the default) or cpu. Without a CUDA device the default
run fails: nonzero exit and a line whose phase names the error; it never
times the CPU in the card's place. A --device cpu run (the tests' mode)
writes its number under full_encode_1080p_m7_ipp_fps_cpu, with
device.platform "cpu".

--gpu-cpu-check: the twin of bench.py --tpu-cpu-check. Encodes 512x256
x10 of make_frames(seed=11), M7, qp 32, IPPP, on the card and on the CPU
and prints one JSON line (device_platform, frames, dims, bytes_device,
bytes_cpu, identical, sha256); exits 1 unless the streams are
byte-identical. Writes no file.

Imports torch, numpy and svt_hevc_tpu_torch only; make_frames is its own
copy of bench.py's generator.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import signal
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

W, H = 1920, 1080
WARMUP_FRAMES = 3          # IDR + first P + one settled P
MAX_FRAMES = 64
TIME_BUDGET_S = 90.0       # steady-state measurement window
DEADLINE_S = 540.0         # wall-clock backstop (SIGALRM)
BASELINE_FPS = 50.0        # 1080p50 real time
METRIC = "full_encode_1080p_m7_ipp_fps"
CHECK_DIMS, CHECK_FRAMES, CHECK_SEED = (512, 256), 10, 11


def new_state() -> dict:
    return {
        "idr_seconds": None,        # first (IDR) access unit's wall time
        "compile_seconds": None,    # first P access unit's wall time
        "steady_frames": 0,
        "steady_seconds": 0.0,
        "decode_ok": None,          # decode == encoder recon
        "psnr_y": None,             # decoded-vs-source luma PSNR
        "phase": "startup",
        "device": None,
        "decoder": None,
        "au_seconds": [],           # each access unit's wall time
    }


_state = new_state()
_emitted = False


def line(s: dict) -> dict:
    """The result line of state s."""
    fps = (s["steady_frames"] / s["steady_seconds"]
           if s["steady_seconds"] > 0 and s["steady_frames"] > 0 else 0.0)
    dev = s["device"] or {"platform": None, "name": None,
                          "power_limit_w": None, "count": 0}
    return {
        "metric": METRIC + ("_cpu" if dev["platform"] == "cpu" else ""),
        "value": round(fps, 3),
        "unit": "frames/s",
        "vs_baseline": round(fps / BASELINE_FPS, 4),
        "idr_seconds": (round(s["idr_seconds"], 3)
                        if s["idr_seconds"] is not None else None),
        "compile_seconds": (round(s["compile_seconds"], 3)
                            if s["compile_seconds"] is not None else None),
        "steady_frames": s["steady_frames"],
        "decode_ok": s["decode_ok"],
        "psnr_y": s["psnr_y"],
        "phase": s["phase"],
        "device": dev,
        "decoder": s["decoder"],
    }


def _emit() -> None:
    """Print the line of _state, once."""
    global _emitted
    if _emitted:
        return
    _emitted = True
    print(json.dumps(line(_state)), flush=True)


def _on_signal(signum, frame):
    _state["phase"] += f"/sig{signum}"
    _emit()
    os._exit(0)


def log(msg: str) -> None:
    print(msg, flush=True)


def make_frames(n, w=W, h=H, seed=7):
    """Synthetic content: textured luma and chroma with a global pan and a
    moving object, so both inter luma and chroma coding do real work
    (bench.py's generator; the same planes for every (n, w, h, seed))."""
    from svt_hevc_tpu_torch.io.yuv import Frame
    rng = np.random.default_rng(seed)
    big = rng.integers(0, 256, (h + 128, w + 128)).astype(np.float32)
    for _ in range(2):
        big = (big + np.roll(big, 1, 0) + np.roll(big, 1, 1)
               + np.roll(big, -1, 0) + np.roll(big, -1, 1)) / 5.0
    big = big * 0.7 + 64
    cbig = rng.integers(0, 256, (h // 2 + 64, w // 2 + 64)).astype(np.float32)
    for _ in range(2):
        cbig = (cbig + np.roll(cbig, 1, 0) + np.roll(cbig, 1, 1)
                + np.roll(cbig, -1, 0) + np.roll(cbig, -1, 1)) / 5.0
    cbig = cbig * 0.25 + 96
    frames = []
    for i in range(n):
        ox, oy = (2 * i) % 64, i % 64
        y = big[oy:oy + h, ox:ox + w].astype(np.uint8).copy()
        sx, sy = (100 + 7 * i) % (w - 200), (80 + 5 * i) % (h - 200)
        y[sy:sy + 96, sx:sx + 96] = 200
        cb = cbig[oy // 2:oy // 2 + h // 2,
                  ox // 2:ox // 2 + w // 2].astype(np.uint8).copy()
        cr = (255 - cbig[oy // 2:oy // 2 + h // 2,
                         ox // 2:ox // 2 + w // 2]).astype(np.uint8).copy()
        cb[sy // 2:sy // 2 + 48, sx // 2:sx // 2 + 48] = 80
        frames.append(Frame(y=y, cb=cb, cr=cr))
    return frames


def bench_config(w=None, h=None):
    """bench.py's configuration: M7, qp 32, 50 fps, IPPP."""
    from svt_hevc_tpu_torch import EncoderConfig
    return EncoderConfig(width=w or W, height=h or H, qp=32, fps_num=50,
                         enc_mode=7, intra_period=-1)


def device_info(device: str) -> dict:
    """{platform, name, power_limit_w, count} of the device that encodes;
    on the card, name and power limit as nvidia-smi gives them."""
    import torch
    if not device.startswith("cuda"):
        return {"platform": "cpu", "name": "cpu", "power_limit_w": None,
                "count": 1}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    name, _, watts = smi.stdout.strip().splitlines()[0].rpartition(", ")
    return {"platform": "gpu", "name": name,
            "power_limit_w": float(watts.split()[0]),
            "count": torch.cuda.device_count()}


def build(device: str) -> None:
    """Build the CUDA kernels (on the card) and the native host emitter
    before any clock starts; raise where the emitter did not build."""
    from svt_hevc_tpu_torch.pipeline.native_emit import native_emit_available
    t0 = time.perf_counter()
    msg = ""
    if device.startswith("cuda"):
        from svt_hevc_tpu_torch.gpu import kernels
        msg = (f"{len(kernels.KERNELS)} CUDA kernels built in "
               f"{kernels.build_all():.3f} s, ")
    if not native_emit_available():
        raise RuntimeError("the native host emitter (native/*.c) did not "
                           "build")
    log(f"build: {msg}native host emitter ready "
        f"({time.perf_counter() - t0:.3f} s)")


def _sync(device: str) -> None:
    if device.startswith("cuda"):
        import torch
        torch.cuda.synchronize()


def timed_encode(enc, frames, state: dict, device: str, on_au=None) -> list:
    """bench.py's timed loop over enc.encode_pictures(frames): fills
    state's idr_seconds, compile_seconds, steady_frames and steady_seconds
    (host clock between yielded access units; the steady clock starts at
    access unit WARMUP_FRAMES - 1) and stops after the access unit that
    ends the TIME_BUDGET_S window, closing the generator. on_au(au), where
    given, runs after each access unit's time is taken. Returns the access
    units."""
    aus = []
    _sync(device)
    t_prev = time.perf_counter()
    t0 = None
    gen = enc.encode_pictures(iter(frames))
    for au in gen:
        now = time.perf_counter()
        aus.append(au)
        if on_au is not None:
            on_au(au)
        state["au_seconds"].append(now - t_prev)
        if au.display_idx == 0:
            state["idr_seconds"] = now - t_prev
        elif au.display_idx == 1:
            state["compile_seconds"] = now - t_prev
        t_prev = now
        if au.display_idx == WARMUP_FRAMES - 1:
            state["phase"] = "steady"
            t0 = now
            continue
        if t0 is not None:
            state["steady_frames"] += 1
            state["steady_seconds"] = now - t0
            if now - t0 > TIME_BUDGET_S:
                break
    gen.close()
    _sync(device)
    return aus


def decode_check(stream: bytes, recons, frames, state: dict,
                 decoder: str | None = None) -> None:
    """Decode stream and compare every plane with the recon; PSNR-Y of the
    decoded luma against the source. decoder: "libde265", "port", or None
    for libde265 where the binding finds the library, else the port's."""
    from svt_hevc_tpu_torch.io import de265_decoder
    if decoder is None:
        decoder = "libde265" if de265_decoder.available() else "port"
    state["decoder"] = decoder
    if decoder == "libde265":
        pics = de265_decoder.decode_annexb(stream)
    else:
        from svt_hevc_tpu_torch.decoder.decoder import decode_stream
        pics = [(d.y, d.cb, d.cr) for d in decode_stream(stream)]
    if len(pics) != len(recons):
        state["decode_ok"] = False
        return
    ok = True
    se = 0.0
    npx = 0
    for (dy, dcb, dcr), rec, fr in zip(pics, recons, frames):
        ok = ok and (np.array_equal(dy, np.asarray(rec.y))
                     and np.array_equal(dcb, np.asarray(rec.cb))
                     and np.array_equal(dcr, np.asarray(rec.cr)))
        src = fr.y.astype(np.float64)
        se += float(((np.asarray(dy, np.float64) - src) ** 2).sum())
        npx += src.size
    state["decode_ok"] = bool(ok)
    state["psnr_y"] = round(
        10 * np.log10(255.0 ** 2 * npx / max(se, 1e-9)), 2)


def run(device: str, state: dict, deadline: bool = False):
    """The benchmark into state: build, encode MAX_FRAMES frames of W x H
    on device through the timed loop, decode-check (deadline: re-arm the
    DEADLINE_S alarm for it). Returns (stream, access units, frames)."""
    from svt_hevc_tpu_torch import Encoder
    state["device"] = device_info(device)
    build(device)
    frames = make_frames(MAX_FRAMES, W, H)
    enc = Encoder(bench_config(W, H), device=device)
    state["phase"] = "warmup"
    log(f"warmup: {W}x{H} x{MAX_FRAMES} M7 qp 32 IPPP on {device}")
    aus = timed_encode(enc, frames, state, device)
    stream = enc.headers() + b"".join(a.data for a in aus)
    p_s = np.array(state["au_seconds"][1:])
    log(f"encoded {len(aus)} pictures, {len(stream)} bytes; IDR "
        f"{state['idr_seconds']:.3f} s, first P "
        f"{state['compile_seconds']:.3f} s, {state['steady_frames']} "
        f"steady pictures in {state['steady_seconds']:.3f} s; P access "
        f"units median {np.median(p_s):.3f} s, min {p_s.min():.3f}, max "
        f"{p_s.max():.3f}, the last (no picture dispatched behind it) "
        f"{p_s[-1]:.3f}")
    log("access unit seconds: " + " ".join(
        f"{t:.3f}" for t in state["au_seconds"]))
    state["phase"] = "decode-check"
    if deadline:
        signal.alarm(int(DEADLINE_S))     # fresh budget for the decode
    t0 = time.perf_counter()
    decode_check(stream, [a.recon for a in aus], frames[:len(aus)], state)
    log(f"decode-check: {state['decoder']} decoded {len(aus)} pictures in "
        f"{time.perf_counter() - t0:.3f} s, decode == recon "
        f"{state['decode_ok']}, PSNR-Y {state['psnr_y']} dB")
    state["phase"] = "done"
    return stream, aus, frames


def gpu_cpu_check(devices=("cuda", "cpu"), dims=CHECK_DIMS,
                  n=CHECK_FRAMES) -> dict:
    """Encode n frames of make_frames(seed=11) at dims (bench.py's check
    configuration: M7, qp 32, IPPP) on devices[0] and on devices[1]."""
    from svt_hevc_tpu_torch import Encoder, EncoderConfig
    w, h = dims
    frames = make_frames(n, w, h, seed=CHECK_SEED)

    def encode(device):
        cfg = EncoderConfig(width=w, height=h, qp=32, enc_mode=7,
                            intra_period=-1)
        return Encoder(cfg, device=device).encode(frames)[0]

    s_dev = encode(devices[0])
    s_cpu = encode(devices[1])
    return {
        "device_platform": ("gpu" if devices[0].startswith("cuda")
                            else devices[0]),
        "frames": n,
        "dims": [w, h],
        "bytes_device": len(s_dev),
        "bytes_cpu": len(s_cpu),
        "identical": s_dev == s_cpu,
        "sha256": hashlib.sha256(s_dev).hexdigest(),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--gpu-cpu-check", action="store_true")
    args = ap.parse_args(argv)
    import torch
    if args.gpu_cpu_check:
        if not torch.cuda.is_available():
            log("FAIL: torch.cuda.is_available() is false")
            return 1
        res = gpu_cpu_check()
        print(json.dumps(res), flush=True)
        return 0 if res["identical"] else 1
    for sig in (signal.SIGTERM, signal.SIGINT, signal.SIGALRM):
        signal.signal(sig, _on_signal)
    signal.alarm(int(DEADLINE_S))
    try:
        if args.device == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("no CUDA device (torch.cuda.is_available() "
                               "is false)")
        run(args.device, _state, deadline=True)
    except Exception as e:            # the line names the error
        _state["phase"] += f"/error: {type(e).__name__}: {e}"
        signal.alarm(0)
        _emit()
        return 1
    signal.alarm(0)
    _emit()
    return 0


if __name__ == "__main__":
    sys.exit(main())
