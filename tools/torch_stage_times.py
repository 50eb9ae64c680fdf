"""Where the time goes in the PyTorch/CUDA port at 1080p, on one GPU.

    python3 tools/torch_stage_times.py [--frames N] [--structure ippp|ra]
                                       [--enc-mode M] [--bit-depth 8|10]
                                       [--tiles C,R] [--sharp]
    python3 tools/torch_stage_times.py --packed

Encodes N frames of the benchmark content (1920x1080, M7 or the preset
--enc-mode gives, qp 32, 8-bit or at --bit-depth 10 the samples times 4
plus 2-bit noise; IPPP, or with --structure ra random access with
hierarchical B, hl=2; --tiles C,R: C x R tiles; --sharp: adaptive QP
for sharpness) twice through Encoder.encode_pictures:

  1. with the port's tracer (svt_hevc_tpu_torch.trace) on, nothing
     synchronised: for every named stage, "p.*" P, "b.*" B and "i.*" I
     pictures, the median host milliseconds (the host's time in it) and
     device milliseconds (between its two CUDA events: where the device
     started and finished its queued work), and for each kernel its
     launches per picture (the tracer's counter deltas). The fused device
     paths: upload, hme_search, the fused device stages, download (with
     its wait), host emitter. The host path (tiles, --sharp, the RD
     presets M0-M5): upload (where the picture has a device context, else
     none), hme_search or dev_me_field (the motion seed), ois_maps,
     qp_map, pass1 (decide and reconstruct), dlf_sao, pass2 (record the
     syntax), cabac, and dpb_upload (the recon into the device DPB).
     torch.profiler traces its steady state: IPPP, the dispatches of
     pictures 2..N-1 and the host walks of pictures 1..N-2, as the
     encoder pipelines them (host-path pictures one at a time: pictures
     2..N-1); RA, every picture after the IDR, one at a time (random
     access is not pipelined). It reports the wall time per picture, the
     device busy time (the union of the device's activity intervals:
     overlapping kernels count once) and the device's idle share;
  2. with the tracer off, for the stream to compare.

The two streams must be byte-identical (the tracer only records). Fails if
the native host emitter did not build. Prints one JSON line.

--packed: instead, the stage-by-stage P pipeline of the packed graphs
(the mesh step's and tools/stage_times.py's split) on picture 2 of 4
IPPP M7 frames against the encoder's oldest device reference, after a
warm-up of two pictures, each stage between two torch.cuda.synchronize()
calls: the source upload, hme_search and the download of its seed,
ois_packed and its download, the luma and chroma phase planes,
dense_md_p_packed, its download and unpack, the host decide_tree (at
CTB 32, with empty intra maps), encode_pass_p_packed and its download.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(1, os.path.join(ROOT, "benchmark"))    # its arithmetic


def packed_split(w=1920, h=1080, device="cuda") -> dict:
    """Milliseconds of each stage of the packed P pipeline (the twin of
    tools/stage_times.py's split) at w x h, synchronized around every
    stage."""
    import numpy as np
    import torch
    from chip_smoke import make_frames
    from svt_hevc_tpu_torch import Encoder, EncoderConfig
    from svt_hevc_tpu_torch.gpu import encode as genc
    from svt_hevc_tpu_torch.gpu.analysis import ois_packed
    from svt_hevc_tpu_torch.gpu.me import hme_search
    from svt_hevc_tpu_torch.pipeline.fast_path import decide_tree

    sync = (torch.cuda.synchronize if torch.device(device).type == "cuda"
            else (lambda: None))
    ms: dict = {}

    def t(label, fn):
        sync()
        t0 = time.perf_counter()
        out = fn()
        sync()
        ms[label] = (time.perf_counter() - t0) * 1e3
        return out

    frames = make_frames(4, w, h, seed=7)
    cfg = EncoderConfig(width=w, height=h, qp=32, fps_num=50,
                        enc_mode=7, intra_period=-1)
    enc = Encoder(cfg, device=device)
    gen = enc.encode_pictures(iter(frames))
    t("warmup 2 pictures", lambda: (next(gen), next(gen)))
    w64 = (cfg.coded_width + 63) // 64 * 64
    h64 = (cfg.coded_height + 63) // 64 * 64
    fr = frames[2]
    src = t("src upload", lambda: genc.prep_planes(
        fr.y, fr.cb, fr.cr, w64, h64, enc.device))
    ref = next(iter(enc._dev_dpb.values()))
    mv = t("hme_search", lambda: hme_search(src[0], ref[0]))
    seed = t("hme seed download", lambda: mv[0].cpu())
    of = t("ois_packed", lambda: ois_packed(src[0]))
    t("ois download", lambda: of.cpu().numpy())
    raws = t("phase planes", lambda: (genc.luma_phase_planes(ref[0]),
                                      genc.chroma_phase_planes(ref[1]),
                                      genc.chroma_phase_planes(ref[2])))
    mdf = t("dense_md_p_packed", lambda: genc.dense_md_p_packed(
        src[0], ref[0], seed.to(enc.device)))
    md = t("dense_md download + unpack", lambda: genc.unpack(
        mdf.cpu().numpy(), genc.md_specs(h64, w64)))
    ois = {n: (np.zeros((h64 // n, w64 // n), np.int32),
               np.full((h64 // n, w64 // n), 10**6, np.int32))
           for n in (4, 8, 16, 32)}
    maps = t("decide_tree (host)", lambda: decide_tree(md, ois, 5))
    tu = np.minimum(maps.cu_log2_8, 5)
    dev = enc.device
    epf = t("encode_pass_p_packed", lambda: genc.encode_pass_p_packed(
        src[0], src[1], src[2], raws[0], raws[1], raws[2],
        torch.from_numpy(maps.mv8).to(dev),
        torch.from_numpy(maps.inter8).to(dev),
        torch.from_numpy(tu).to(dev), 32, 32))
    t(f"encode_pass download ({epf.numel() * 2} bytes)",
      lambda: epf.cpu().numpy())
    return ms


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
    ap.add_argument("--packed", action="store_true",
                    help="the packed graphs' stage-by-stage P split")
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
    from svt_hevc_tpu_torch.gpu import kernels as K
    from svt_hevc_tpu_torch.pipeline.native_emit import native_emit_available
    from torch_compare_reference import card_line

    if not native_emit_available():
        print("FAIL: the native host emitter (native/*.c) did not build",
              flush=True)
        return 1
    K.build_all()
    if args.packed:
        if (args.structure, args.enc_mode, args.bit_depth, cols, rows,
                args.sharp) != ("ippp", 7, 8, 1, 1, False):
            ap.error("--packed times the 8-bit M7 IPPP fused P picture")
        print(json.dumps({"card": card_line("cuda"),
                          "packed_ms": packed_split()}), flush=True)
        return 0
    n = args.frames
    frames = make_frames(n, 1920, 1080, seed=7, bit_depth=args.bit_depth)
    ra = args.structure == "ra"
    extra = dict(pred_structure=2, hierarchical_levels=2) if ra else {}
    cfg = EncoderConfig(width=1920, height=1080, qp=32, fps_num=50,
                        enc_mode=args.enc_mode, bit_depth=args.bit_depth,
                        intra_period=-1, tile_columns=cols, tile_rows=rows,
                        improve_sharpness=args.sharp, **extra)

    # ---- 1. the tracer on, the profiler over the steady state
    from svt_hevc_tpu_torch import trace
    from torch.profiler import ProfilerActivity, profile
    from harness import _gpu_events
    from yardstick import union_ns
    prof = profile(activities=[ProfilerActivity.CUDA])
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

    tr = trace.Tracer("cuda").start()
    try:
        if ra:
            gen = Encoder(cfg).encode_pictures(frames)
            traced = [next(gen).data]                  # the IDR
            torch.cuda.synchronize()
            prof.start()
            window["t0"] = time.perf_counter()
            traced += [au.data for au in gen]
            torch.cuda.synchronize()
            window["wall"] = time.perf_counter() - window["t0"]
            prof.stop()
            pics = n - 1
        else:
            traced = [au.data for au in Encoder(cfg).encode_pictures(feed())]
            pics = n - 2
    finally:
        out = tr.stop()
    stages: dict = {}
    for sp in out["spans"]:
        if sp["name"].split(".")[0] in ("i", "p", "b"):
            ent = stages.setdefault(sp["name"], {"host": [], "device": []})
            for clock, key in (("host_ns", "host"), ("device_ns", "device")):
                a, b = sp[clock]
                ent[key].append((b - a) / 1e6)

    # ---- 2. the tracer off
    plain = [au.data for au in Encoder(cfg).encode_pictures(frames)]
    events = [(a, b) for _, a, b in _gpu_events(prof, "cuda")]
    busy = (union_ns(events, min(s for s, _ in events),
                     max(e for _, e in events)) / 1e9 if events else 0.0)
    wall = window["wall"]
    res = {
        "card": card_line("cuda"), "frames": n, "structure": args.structure,
        "enc_mode": args.enc_mode, "bit_depth": args.bit_depth,
        "tiles": [cols, rows], "sharp": args.sharp,
        "streams_equal": traced == plain,
        "stages": {k: {"calls": len(v["host"]),
                       "median_host_ms": float(np.median(v["host"])),
                       "median_device_ms": float(np.median(v["device"]))}
                   for k, v in stages.items()},
        "launches_per_picture": {k: v / n for k, v in
                                 out["deltas"]["launches"].items()},
        "wavefront_steps_per_picture":
            out["deltas"]["wavefront"]["steps"] / n,
        ("after_idr_profiled" if ra else "steady_p_profiled"): {
            "pictures": pics, "wall_s_per_picture": wall / pics,
            "device_busy_s_per_picture": busy / pics,
            "device_idle_share": 1.0 - busy / wall,
            "device_events_per_picture": len(events) / pics},
    }
    print(json.dumps(res), flush=True)
    return 0 if traced == plain else 1


if __name__ == "__main__":
    sys.exit(main())
