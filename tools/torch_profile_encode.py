"""Host profile of the PyTorch/CUDA port: cProfile's top functions by
cumulative time over a 1080p M7 qp 32 IPPP encode, after a warm-up of two
pictures.

    python3 tools/torch_profile_encode.py [--frames N] [--tiles C,R]
                                          [--sharp] [--device cuda|cpu]
                                          [--width W --height H]

Frames: chip_smoke.make_frames(N, W, H, seed=7), the repository
benchmark's content. --tiles C,R (C x R tiles) and --sharp (adaptive QP
for sharpness) take the host path. --device: the encoder's device
(default cuda; without a CUDA device the encoder raises, it does not
fall back to the CPU); --device cpu and a small --width / --height are
for a quick run without the card. cProfile adds cost to every Python
call and none to the device or to native code, so its shares locate
host hotspots; times come from tools/torch_stage_times.py. The twin of
tools/profile_encode.py; it imports nothing of the JAX package.
"""

from __future__ import annotations

import argparse
import cProfile
import io
import os
import pstats
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=6)
    ap.add_argument("--tiles", default="1,1",
                    help="tile columns,rows (more than one: the host path)")
    ap.add_argument("--sharp", action="store_true",
                    help="adaptive QP for sharpness (the host path)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1080)
    args = ap.parse_args()
    if args.frames < 3:
        ap.error("--frames must be at least 3 (two warm-up pictures)")
    cols, rows = (int(v) for v in args.tiles.split(","))

    import torch
    from chip_smoke import make_frames
    from svt_hevc_tpu_torch import Encoder, EncoderConfig
    from torch_compare_reference import card_line

    card = card_line(args.device)
    if card:
        print(f"card: {card}", flush=True)
    frames = make_frames(args.frames, args.width, args.height, seed=7)
    cfg = EncoderConfig(width=args.width, height=args.height, qp=32,
                        fps_num=50, enc_mode=7, intra_period=-1,
                        tile_columns=cols, tile_rows=rows,
                        improve_sharpness=args.sharp)
    enc = Encoder(cfg, device=args.device)
    gen = enc.encode_pictures(iter(frames))
    t0 = time.perf_counter()
    next(gen)
    next(gen)
    print(f"warmup (2 pictures): {time.perf_counter() - t0:.3f} s",
          flush=True)

    pr = cProfile.Profile()
    t0 = time.perf_counter()
    pr.enable()
    cnt = 0
    for _ in gen:
        cnt += 1
    if card:
        torch.cuda.synchronize()
    pr.disable()
    dt = time.perf_counter() - t0
    print(f"{cnt} pictures in {dt:.3f} s = {cnt / dt:.3f} fps on "
          f"{args.device}", flush=True)
    s = io.StringIO()
    pstats.Stats(pr, stream=s).sort_stats("cumulative").print_stats(45)
    print(s.getvalue(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
