"""Command-line encoder app: raw YUV / Y4M in, Annex-B HEVC out.

Port of svt_hevc_tpu/app.py: the same tokens with the same defaults
(-i, -b, -w, -h, -q, -n, -fps, -intra-period, -rc, -tbr, -vbv-maxrate,
-vbv-bufsize, -o recon file, ...), plus -device {cuda,cpu} (default
cuda): the encode runs on the card, and raises where there is none
unless -device cpu asks for the CPU. Mesh picture parallelism (several
devices) raises NotImplementedError.

Usage:
    python -m svt_hevc_tpu_torch.app -i in.yuv -w 352 -h 288 -q 32 -b out.265
    python -m svt_hevc_tpu_torch.app -i in.y4m -b out.265 -n 30
    python -m svt_hevc_tpu_torch.app -i in.yuv -w 1920 -h 1080 \\
        -bit-depth 10 -encMode 8 -intra-period -1 -rc 1 -tbr 4000000 -b out.265
"""

from __future__ import annotations

import argparse
import sys
import time

from .config import EncoderConfig
from .io.yuv import read_y4m, read_yuv, write_yuv420
from .pipeline.encoder import Encoder


def build_parser() -> argparse.ArgumentParser:
    # add_help=False: like the reference CLI, -h means height
    p = argparse.ArgumentParser(
        prog="svt_hevc_tpu_torch", description="HEVC encoder on the GPU",
        fromfile_prefix_chars="@", add_help=False)
    p.add_argument("--help", action="help")
    p.add_argument("-i", "--input", required=True, action="append",
                   help="input file (.yuv raw 4:2:0 or .y4m); repeat for "
                        "multi-channel (encoded one after another)")
    p.add_argument("-b", "--bitstream", required=True, action="append",
                   help="output HEVC Annex-B file (one per -i)")
    p.add_argument("-o", "--recon", help="optional recon YUV output")
    p.add_argument("-w", "--width", type=int, default=0)
    p.add_argument("-h", "--height", type=int, default=0)
    p.add_argument("-n", "--frames", type=int, default=None,
                   help="number of frames to encode")
    p.add_argument("-q", "--qp", type=int, default=32)
    p.add_argument("-color-format", type=int, default=1, dest="color_format",
                   choices=[1, 2, 3], help="1=420, 2=422, 3=444")
    p.add_argument("-bit-depth", type=int, default=8, dest="bit_depth",
                   choices=[8, 10])
    p.add_argument("-fps", type=int, default=50)
    p.add_argument("-intra-period", type=int, default=0, dest="intra_period",
                   help="0=all intra, -1=first only, N=period")
    p.add_argument("-encMode", "--enc-mode", type=int, default=7,
                   dest="enc_mode")
    p.add_argument("-rc", type=int, default=0, choices=[0, 1],
                   help="0=CQP 1=VBR")
    p.add_argument("-tbr", "--target-bitrate", type=int, default=0,
                   dest="tbr", help="target bitrate (bits/s) for -rc 1")
    p.add_argument("-vbv-maxrate", type=int, default=0, dest="vbv_maxrate")
    p.add_argument("-vbv-bufsize", type=int, default=0, dest="vbv_bufsize")
    p.add_argument("-dlf", type=int, default=1, help="deblocking on/off")
    p.add_argument("-sao", type=int, default=1, help="SAO on/off")
    p.add_argument("-rd", type=int, default=0,
                   help="full RD mode decision (the host path)")
    p.add_argument("-lcu", "--ctb-size", type=int, default=32,
                   dest="ctb_size", choices=[16, 32, 64])
    p.add_argument("-tile-columns", type=int, default=1, dest="tile_columns")
    p.add_argument("-tile-rows", type=int, default=1, dest="tile_rows")
    p.add_argument("-tile-slice-mode", type=int, default=0,
                   dest="tile_slice_mode", choices=[0, 1],
                   help="1: one slice NAL per tile")
    p.add_argument("-lad", "--look-ahead", type=int, default=-1, dest="lad",
                   help="lookahead distance for VBR (-1 auto)")
    p.add_argument("-hrd", type=int, default=0,
                   help="signal HRD (VUI + buffering period / pic timing)")
    p.add_argument("-denoise", type=int, default=0, help="source denoise")
    p.add_argument("-sharp", type=int, default=0,
                   help="adaptive QP for sharpness")
    p.add_argument("-brr", type=int, default=0,
                   help="masking-based bitrate reduction")
    p.add_argument("-scd", type=int, default=1,
                   help="scene change detection on/off")
    p.add_argument("-cip", "--constrained-intra", type=int, default=0,
                   dest="cip", help="constrained intra prediction")
    p.add_argument("-qp-file", dest="qp_file",
                   help="file with one QP per frame")
    p.add_argument("-speed-ctrl", type=float, default=0, dest="speed_ctrl",
                   help="dynamic preset toward this encode fps")
    p.add_argument("-pred-struct", type=int, default=0, dest="pred_struct",
                   choices=[0, 1, 2], help="0 LDP, 1 LDB, 2 random access")
    p.add_argument("-hierarchical-levels", type=int, default=0, dest="hl")
    p.add_argument("-y4m", action="store_true",
                   help="force Y4M parsing (for stdin pipes)")
    p.add_argument("-device", default="cuda", choices=["cuda", "cpu"],
                   help="where the encode runs (cuda: the GPU, raises "
                        "without one)")
    return p


def frames_from(args, path):
    """Frame iterator from a file path or '-' (stdin pipe): raw YUV, or
    Y4M with -y4m, e.g.

        ffmpeg -i in.mp4 -f rawvideo -pix_fmt yuv420p - | \\
          python -m svt_hevc_tpu_torch.app -i - -w W -h H -b out.265
    """
    if path == "-":
        f = sys.stdin.buffer
        if args.y4m:
            return read_y4m(f, max_frames=args.frames)
        if not args.width or not args.height:
            raise SystemExit("-w/-h are required for raw stdin input")
        return read_yuv(f, args.width, args.height,
                        max_frames=args.frames, bit_depth=args.bit_depth,
                        chroma_format=args.color_format)
    if path.endswith(".y4m") or args.y4m:
        return read_y4m(path, max_frames=args.frames)
    if not args.width or not args.height:
        raise SystemExit("-w/-h are required for raw .yuv input")
    return read_yuv(path, args.width, args.height,
                    max_frames=args.frames, bit_depth=args.bit_depth,
                    chroma_format=args.color_format)


def config_from_args(args, w: int, h: int) -> EncoderConfig:
    """The encoder configuration the parsed tokens select for a w x h
    input."""
    return EncoderConfig(
        width=w, height=h, qp=args.qp, fps_num=args.fps,
        bit_depth=args.bit_depth, chroma_format=args.color_format,
        intra_period=args.intra_period, enc_mode=args.enc_mode,
        rate_control_mode=args.rc, target_bitrate=args.tbr,
        vbv_maxrate=args.vbv_maxrate, vbv_bufsize=args.vbv_bufsize,
        enable_deblocking=bool(args.dlf), enable_sao=bool(args.sao),
        ctb_size=args.ctb_size,
        tile_columns=args.tile_columns, tile_rows=args.tile_rows,
        tile_slice_mode=args.tile_slice_mode,
        pred_structure=args.pred_struct, hierarchical_levels=args.hl,
        look_ahead_distance=args.lad, enable_hrd=bool(args.hrd),
        enable_denoise=bool(args.denoise),
        improve_sharpness=bool(args.sharp), bit_rate_reduction=bool(args.brr),
        scene_change_detection=bool(args.scd),
        constrained_intra=bool(args.cip),
    )


def _encode_channel(args, in_path, out_path, recon_path=None):
    frames = list(frames_from(args, in_path))
    if not frames:
        raise SystemExit(f"no frames read from {in_path}")
    w, h = frames[0].width, frames[0].height
    cfg = config_from_args(args, w, h)
    enc = Encoder(cfg, device=args.device)
    if args.speed_ctrl:
        enc.set_speed_control(args.speed_ctrl)
    frame_qps = None
    if args.qp_file:
        with open(args.qp_file) as f:
            frame_qps = [int(t) for t in f.read().split() if t.strip()]
    t0 = time.perf_counter()
    stream, recons = enc.encode(frames, rd=True if args.rd else None,
                                frame_qps=frame_qps)
    dt = time.perf_counter() - t0

    if out_path == "-":
        # Annex-B to stdout for a downstream pipe (h265parse, a muxer)
        sys.stdout.buffer.write(stream)
        sys.stdout.buffer.flush()
    else:
        with open(out_path, "wb") as f:
            f.write(stream)
    if recon_path:
        write_yuv420(recon_path, recons)

    n = len(frames)
    psnr = sum(r.psnr(f)[0] for r, f in zip(recons, frames)) / n
    kbps = 8 * len(stream) * (args.fps / n) / 1000.0
    log = sys.stderr if out_path == "-" else sys.stdout
    print(f"{in_path}: encoded {n} frames {w}x{h}: {len(stream)} bytes "
          f"({kbps:.1f} kbit/s @ {args.fps} fps), "
          f"avg PSNR-Y {psnr:.2f} dB, {n / dt:.2f} fps encode speed",
          file=log)
    return n, dt


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if len(args.input) != len(args.bitstream):
        raise SystemExit("need one -b per -i")
    total_frames = 0
    total_dt = 0.0
    for ch, (inp, outp) in enumerate(zip(args.input, args.bitstream)):
        n, dt = _encode_channel(args, inp, outp,
                                args.recon if ch == 0 else None)
        total_frames += n
        total_dt += dt
    if len(args.input) > 1:
        print(f"multi-channel: {len(args.input)} channels, "
              f"{total_frames / total_dt:.2f} aggregate fps")
    return 0


if __name__ == "__main__":
    sys.exit(main())
