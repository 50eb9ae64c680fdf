"""Where the time goes in the PyTorch/CUDA port at 1080p, on one GPU.

    python3 tools/torch_stage_times.py [--frames N] [--structure ippp|ra]
                                       [--enc-mode M] [--bit-depth 8|10]
                                       [--tiles C,R] [--sharp]

Encodes N frames of the benchmark content (1920x1080, M7 or the preset
--enc-mode gives, qp 32, 8-bit or at --bit-depth 10 the samples times 4
plus 2-bit noise; IPPP, or with --structure ra random access with
hierarchical B, hl=2; --tiles C,R: C x R tiles; --sharp: adaptive QP
for sharpness) twice through Encoder.encode_pictures:

  1. with the stage hook of gpu.encode (STAGE_TIMER) set: every stage of
     the picture pipelines runs between two torch.cuda.synchronize()
     calls, so each stage's wall time includes its device work; "p.*" P,
     "b.*" B and "i.*" I pictures. The fused device paths: upload,
     hme_search, the fused device stages, download, host emitter. The
     host path (tiles, --sharp, the RD presets M0-M5): upload (where the
     picture has a device context, else none), hme_search or
     dev_me_field (the motion seed), ois_maps, qp_map, pass1 (decide
     and reconstruct), dlf_sao, pass2 (record the syntax), cabac, and
     dpb_upload (the recon into the device DPB);
  2. without the hook, on a fresh encoder, with torch.profiler tracing the
     steady state. IPPP: the dispatches of pictures 2..N-1 and the host
     walks of pictures 1..N-2, as the encoder pipelines them (host-path
     pictures one at a time: pictures 2..N-1). RA: every picture after
     the IDR, one at a time (random access is not pipelined). It reports
     the wall time per picture, the device busy time (sum of device
     event times) and the device's idle share.

The two streams must be byte-identical (the hook only times). Fails if
the native host emitter did not build. Prints one JSON line.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


class StageTimer:
    """gpu.encode.STAGE_TIMER: synchronized wall time and kernel launches
    of every named stage, in call order."""

    def __init__(self, kernels):
        self.kernels = kernels
        self.rows: list[tuple[str, float, list[int]]] = []

    @contextlib.contextmanager
    def stage(self, name: str):
        import torch
        torch.cuda.synchronize()
        c0 = [k.launches for k in self.kernels]
        t0 = time.perf_counter()
        yield
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        self.rows.append((name, dt, [k.launches - c for k, c in
                                     zip(self.kernels, c0)]))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=5)
    ap.add_argument("--structure", choices=("ippp", "ra"), default="ippp")
    ap.add_argument("--enc-mode", type=int, default=7, choices=range(12),
                    help="preset (M0-M5 take the RD host path, M8-M9 put "
                         "intra CUs in inter pictures)")
    ap.add_argument("--bit-depth", type=int, default=8, choices=(8, 10))
    ap.add_argument("--tiles", default="1,1",
                    help="tile columns,rows (more than one: the host path)")
    ap.add_argument("--sharp", action="store_true",
                    help="adaptive QP for sharpness (the host path)")
    args = ap.parse_args()
    if args.frames < 4:
        ap.error("--frames must be at least 4 (two warm-up pictures)")
    cols, rows = (int(v) for v in args.tiles.split(","))

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("FAIL: no CUDA device", flush=True)
        return 1
    from chip_smoke import make_frames
    from svt_hevc_tpu_torch import Encoder, EncoderConfig
    from svt_hevc_tpu_torch.gpu import encode as genc
    from svt_hevc_tpu_torch.gpu import kernels as K
    from svt_hevc_tpu_torch.pipeline.native_emit import native_emit_available

    if not native_emit_available():
        print("FAIL: the native host emitter (native/*.c) did not build",
              flush=True)
        return 1
    K.build_all()
    n = args.frames
    frames = make_frames(n, 1920, 1080, seed=7, bit_depth=args.bit_depth)
    ra = args.structure == "ra"
    extra = dict(pred_structure=2, hierarchical_levels=2) if ra else {}
    cfg = EncoderConfig(width=1920, height=1080, qp=32, fps_num=50,
                        enc_mode=args.enc_mode, bit_depth=args.bit_depth,
                        intra_period=-1, tile_columns=cols, tile_rows=rows,
                        improve_sharpness=args.sharp, **extra)

    # ---- 1. every stage synchronized
    timer = StageTimer(K.KERNELS)
    genc.STAGE_TIMER = timer
    try:
        staged = [au.data for au in Encoder(cfg).encode_pictures(frames)]
    finally:
        genc.STAGE_TIMER = None
    stages: dict = {}
    for name, dt, launches in timer.rows:
        ent = stages.setdefault(name, {"s": [], "launches": []})
        ent["s"].append(dt)
        ent["launches"].append(launches)

    # ---- 2. the steady state under the profiler
    from torch.profiler import ProfilerActivity, profile
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    window: dict = {}

    def feed():
        for i, f in enumerate(frames):
            if i == 2:
                torch.cuda.synchronize()
                prof.start()
                window["t0"] = time.perf_counter()
            yield f
        # asked for a frame past the last: the walk of picture n-2 is done
        torch.cuda.synchronize()
        window["wall"] = time.perf_counter() - window["t0"]
        prof.stop()

    if ra:
        gen = Encoder(cfg).encode_pictures(frames)
        plain = [next(gen).data]                  # the IDR
        torch.cuda.synchronize()
        prof.start()
        window["t0"] = time.perf_counter()
        plain += [au.data for au in gen]
        torch.cuda.synchronize()
        window["wall"] = time.perf_counter() - window["t0"]
        prof.stop()
        pics = n - 1
    else:
        plain = [au.data for au in Encoder(cfg).encode_pictures(feed())]
        pics = n - 2
    dev_us = 0.0
    n_events = 0
    for ev in prof.events():
        if "CUDA" in str(ev.device_type):
            dev_us += ev.time_range.elapsed_us()
            n_events += 1
    wall = window["wall"]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    res = {
        "card": smi, "frames": n, "structure": args.structure,
        "enc_mode": args.enc_mode, "bit_depth": args.bit_depth,
        "tiles": [cols, rows], "sharp": args.sharp,
        "streams_equal": staged == plain,
        "kernels": [k.name for k in K.KERNELS],
        "stages": {k: {"median_s": float(np.median(v["s"])),
                       "calls": len(v["s"]),
                       "launches_per_call": [
                           float(np.median(c)) for c in zip(*v["launches"])]}
                   for k, v in stages.items()},
        ("after_idr_profiled" if ra else "steady_p_profiled"): {
            "pictures": pics, "wall_s_per_picture": wall / pics,
            "device_busy_s_per_picture": dev_us / 1e6 / pics,
            "device_idle_share": 1.0 - dev_us / 1e6 / wall,
            "device_events_per_picture": n_events / pics},
    }
    print(json.dumps(res), flush=True)
    return 0 if staged == plain else 1


if __name__ == "__main__":
    sys.exit(main())
