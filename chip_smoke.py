"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (one line each, with seconds; any failure exits nonzero). The
timed card phases (kernels, main, ra, cli_1080p, host_1080p) run first
with nothing else on the host; then the CPU reference encodes of every
check run in worker processes while the card encodes the small clips:
  1. card      name / power limit (nvidia-smi) and versions
  2. build     nvcc builds of the CUDA kernels (csrc/), all at once, with
               each kernel's registers, shared memory and spills, and
               the native host emitter (native/*.c, the system compiler)
  3. kernels   every kernel against its plain PyTorch version on the
               card at the 1080p main-path shapes (torch.equal), the
               batched K2 shapes the callers use included, 8-bit and
               10-bit (K1 and K2 timed at both), with two
               times per variant: device_ms, the kernel's time (CUDA
               events around R_LAUNCHES back-to-back launches, over R),
               and call_ms, the host-inclusive time of one wrapper call
               (what a launch-bound caller pays); the plain version's
               device time and the bound beside them
  4. main      1920x1080 x 5 frames, M7, qp 32, IPPP, on the card: IDR /
               first P / steady P seconds, kernel launches per P picture
               (all > 0), recon PSNR
  5. ra        1920x1080 x 5 frames, M7, qp 32, random access (hl=2: I0
               P4 B2 B1 B3), on the card: IDR, P-anchor and per-layer B
               seconds per picture, kernel launches per B picture (all >
               0), recon PSNR
  6. cli_1080p the command line (svt_hevc_tpu_torch.app's main, in a
               subprocess on the card) on a seeded 1920x1080 10-bit raw
               clip of 5 frames with new textured ramps on the odd
               pictures:
               -bit-depth 10 -encMode 8 -intra-period -1 -rc 1 -tbr
               8000000 -fps 50 (VBR, default lookahead 17): IDR and per-P
               seconds, the P pictures that carry intra CUs, the
               wavefront steps they ran (at least one) and its seconds,
               the host's wait in the any_intra read, QP per picture,
               kbit/s against the target, K1 / K2 launches per P picture
               (all > 0), PSNR-Y, decode == recon; lookahead_stats card
               == CPU on the clip's batch and its time at batches of 6
               and 37 frames
  7. host_1080p
               the host path's target configuration: 1920x1080 x 3
               frames, M7, qp 32, IPPP, 2x2 tiles, improve_sharpness
               (adaptive QP with the content classes), on the card:
               seconds and bytes per picture, K1 launches per picture
               (the motion seed, > 0 in each P picture), the QP maps, the
               synchronized stage split (dev_me_field, ois_maps, qp_map,
               pass 1, DLF + SAO, pass 2, CABAC), decode == recon; the
               device times of ois_packed, ctb_activity and denoise_plane
               (8 and 10 bits) at 1920x1088
  8. small     512x256 x 10 frames, M7, qp 32, IPPP, on the card and on
               the CPU: streams byte-identical, equal to the reference
               sha256, decoded by the port's decoder to the recon
  9. small_ra  512x256 x 9 frames, M7, qp 32, random access (hierarchical
               B, hl=2), on the card and on the CPU: streams
               byte-identical, equal to the reference sha256, decoded by
               the port's decoder to the recon
 10. small_new 512x256 clips of M8-M9, 10-bit and VBR the same way
               (card == CPU == reference sha256, decode == recon): M8
               IPPP x10 and M9 RA hl=2 x9 (new ramps on the odd pictures;
               intra CUs in P and in B pictures asserted), 10-bit M7 IPPP
               x10, VBR with lookahead 8 x10
 11. variants  the other fused-path configurations (presets M6, M10,
               M11; hierarchical low-delay P; low-delay B; random access
               hl=1; open GOP with a CRA and RASL pictures), 512x256 x 5
               frames each (x 9 for the open GOP): card stream == CPU
               stream, decoded to the recon
 12. stream_variants
               further paths, 512x256, card == CPU, decode == recon:
               10-bit RA hl=2, 10-bit M8 low-delay B, VBR with
               hierarchical low-delay P, a checkpoint split on the card
               == the continuous encode, a CPU-made checkpoint restored
               on the card, EncoderHandle streaming == batch, speed
               control (the dynamic preset rising to M11)
 13. small_host
               the host path at small sizes, card == CPU, decode ==
               recon: 2x2 tiles, 4:2:2, improve_sharpness, constrained
               intra (a fused I and host P pictures), M5 (256x128) and
               denoise (a noisy source, then the fused path) against the
               JAX streams' sha256; MCTS, sharpness with a slice per
               tile, 4:4:4 RA hl=2, sharpness RA hl=2 (host-path B
               pictures), bit-rate reduction at 10 bits, segment
               overrides, M0 (256x128) and speed control rising from M5
               into the fused presets
 14. host_check
               every device helper of phase host_1080p (the two ME
               fields, the three pictures' OIS maps, ctb_activity and QP
               maps) and denoise_plane of the clip's frames at 8 and 10
               bits equal to a CPU computation from the same inputs (in a
               worker, with the plain versions)
 15. cpu_1080p the main phase's I + P access units equal to a CPU encode
               of the first two frames; the ra phase's I0, P4 and B2
               access units equal to the first three of a CPU encode of
               the same frames; the cli_1080p stream's I + P access units
               equal to the first two of a CPU encode of its 5 frames
               (the lookahead sees the same frames)
The line before the last is the kernel JSON, the last line the device
JSON. Imports nothing of JAX.

    python3 chip_smoke.py --cli-probe OUT.json -- <app tokens>

runs the command line's main with those tokens and writes, per access
unit, its seconds, kernel launches, intra wavefront runs, steps and
seconds and the any_intra wait to OUT.json (what phase cli_1080p starts
in a subprocess).
"""

from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

# the JAX reference package's stream for the small clip (512x256 x 10,
# make_frames(seed=11), M7, qp 32, intra_period=-1), computed on the CPU
SMALL_SHA256 = \
    "31a6c0ca5957f609b9a27937e71866293ef65cd017382cedc71b48c29ead7cf3"
SMALL_BYTES = 19785
# the same for the random-access clip (512x256 x 9, make_frames(seed=11),
# M7, qp 32, intra_period=-1, pred_structure=2, hierarchical_levels=2)
SMALL_RA_SHA256 = \
    "a58e32f64015bc5da7dd08107a31be473bbc524109a254139beca681ef491a98"
SMALL_RA_BYTES = 18639

# The JAX reference package's streams of the M8-M9, 10-bit and VBR small
# clips (512x256, qp 32, intra_period=-1, fps_num=50), computed on the CPU:
# (config, frames, make_frames arguments beyond seed=11, sha256, bytes)
SMALL_NEW = {
    "small_m8": (dict(enc_mode=8), 10, dict(patches=True),
                 "467a9bec7fcf7ff4b2498119556ad06c"
                 "276adf0eb531b7030599445f9564beac", 28245),
    "small_m9_ra": (dict(enc_mode=9, pred_structure=2,
                         hierarchical_levels=2), 9, dict(patches=True),
                    "c07c89c6806b1ec27bbcab88873099d3"
                    "2f1340e259dc144c0f6ac96a739c5417", 22018),
    "small_10bit": (dict(bit_depth=10), 10, dict(bit_depth=10),
                    "7148f1d9b445139bc512b1403dada2b9"
                    "1a4a12f2cf0476af7b09d85520a85e0a", 32290),
    "small_vbr": (dict(rate_control_mode=1, target_bitrate=600_000,
                       look_ahead_distance=8), 10, {},
                  "a82e9c195a06741901f99434196bfe3d"
                  "6eb1cbc46a334c9684b930b750323b9e", 15400),
}

# phase cli_1080p: the command line's tokens (beyond -i / -b / -o) and
# its clip, 5 frames of make_frames(seed=7, patches=True, bit_depth=10)
CLI_FRAMES = 5
CLI_TBR = 8_000_000
CLI_TOKENS = ["-w", "1920", "-h", "1080", "-bit-depth", "10", "-encMode",
              "8", "-intra-period", "-1", "-rc", "1", "-tbr", str(CLI_TBR),
              "-fps", "50"]

# phase host_1080p: the host path's target configuration (1920x1080 M7
# qp 32 IPPP, 2x2 tiles, sharpness-driven adaptive QP) on
# make_frames(HOST_FRAMES, 1920, 1080, seed=7)
HOST_FRAMES = 3
HOST_KW = dict(tile_columns=2, tile_rows=2, improve_sharpness=True)

# The JAX reference package's host-path streams of phase small_host
# (qp 32, M7 unless stated, intra_period=-1, fps_num=50, make_frames(
# seed=11, ...)), computed on the CPU: (config, frames, make_frames
# arguments beyond seed=11, width, height, sha256, bytes)
SMALL_HOST = {
    "host_tiles_2x2": (dict(tile_columns=2, tile_rows=2), 3, {}, 512, 256,
                       "8dea6afd9e8fd424c034f9759a9bf6f4"
                       "4f0323c30a7676dfb648564b2a9763b9", 16785),
    "host_422": (dict(chroma_format=2), 3, dict(chroma_format=2), 512, 256,
                 "2e9f6f80c5e421bd73a95993f5b8396d"
                 "983040962cc96ee69764207e0a0def27", 17429),
    "host_sharp": (dict(improve_sharpness=True), 3, {}, 512, 256,
                   "b98c8fa157763617fef88b0dd513dc3f"
                   "cee32b0c565a4d93d733dd32a4addaac", 16143),
    "host_cip": (dict(constrained_intra=True), 3, {}, 512, 256,
                 "fb820f6510393291ec4a39fd82a3ca84"
                 "bbb28b4fbbcd4dd719e6f95fe061e602", 16151),
    "host_m5": (dict(enc_mode=5), 3, {}, 256, 128,
                "ba947e104955e40bbd57b9d1c79182ce"
                "08e55a8e7868f55222cfad8a6e659451", 3959),
    # the fused path behind the denoiser (noise of sd 4 on the luma)
    "host_denoise": (dict(enable_denoise=True), 3, dict(noise=4.0), 512,
                     256, "e594d6bc861835510800cc80bc8cfa31"
                     "bba262f34fc015f25b1e57738c2dafd5", 5005),
}
# the other host-path configurations of the CPU tests, card == CPU only:
# (name, config, frames, make_frames arguments, width, height, mode);
# mode plain, sov (segment overrides on the first and third pictures) or
# speed (speed control toward 1e9 fps, rising from M5 into the fused
# presets)
HOST_VARIANTS = (
    ("MCTS 2x1", dict(tile_columns=2, constrained_motion_tiles=True), 3,
     {}, 512, 256, "plain"),
    ("sharp, 2x2 tiles, a slice per tile",
     dict(tile_columns=2, tile_rows=2, tile_slice_mode=1,
          improve_sharpness=True), 3, {}, 512, 256, "plain"),
    ("4:4:4 RA hl=2", dict(chroma_format=3, pred_structure=2,
                           hierarchical_levels=2), 5,
     dict(chroma_format=3), 512, 256, "plain"),
    ("sharp RA hl=2", dict(improve_sharpness=True, pred_structure=2,
                           hierarchical_levels=2), 5, {}, 512, 256,
     "plain"),
    ("brr 10-bit", dict(bit_rate_reduction=True, bit_depth=10), 3,
     dict(bit_depth=10), 512, 256, "plain"),
    ("segment overrides", dict(segment_ov_enabled=True), 3, {}, 512, 256,
     "sov"),
    ("M0", dict(enc_mode=0), 2, {}, 256, 128, "plain"),
    ("speed control from M5", dict(enc_mode=5), 4, {}, 256, 128, "speed"),
)

# launches per device-time sample (CUDA events around a run of many
# launches)
R_LAUNCHES = 200

# worker processes (and torch threads in each) for the CPU reference
# encodes: most of a CPU encode is the IDR's sequential wavefront of small
# steps, which more threads do not speed up; three workers take the
# three 1080p references, the others the small clips
CPU_WORKERS = 5
CPU_THREADS = 2

RA_KW = dict(pred_structure=2, hierarchical_levels=2)
# (config, frames) of phase variants, 512x256
VARIANTS = ((dict(enc_mode=6), 5), (dict(enc_mode=10), 5),
            (dict(enc_mode=11), 5), (dict(hierarchical_levels=2), 5),
            (dict(pred_structure=1), 5),
            (dict(pred_structure=2, hierarchical_levels=1), 5),
            # a CRA at POC 8 with the RASL pictures 6, 5 and 7
            (dict(pred_structure=2, hierarchical_levels=2,
                  intra_refresh_type=1, intra_period=7), 9))
# phase stream_variants, 512x256 of make_frames(seed=11, **frame
# arguments): (name, config, frames, frame arguments, mode); mode plain: card
# stream == CPU stream; split: checkpoint after 3 pictures on the card,
# restored into a fresh card encoder; ckpt_cpu: the CPU encodes 3 pictures
# and checkpoints, the card restores and encodes the rest; handle:
# EncoderHandle on the card; speed: speed control toward 1e9 fps on both
STREAM_VARIANTS = (
    ("10-bit RA hl=2", dict(bit_depth=10, **RA_KW), 5, dict(bit_depth=10),
     "plain"),
    ("10-bit M8 LDB", dict(bit_depth=10, enc_mode=8, pred_structure=1), 5,
     dict(bit_depth=10, patches=True), "plain"),
    ("VBR hier LD-P", dict(rate_control_mode=1, target_bitrate=600_000,
                           hierarchical_levels=2), 5, {}, "plain"),
    ("checkpoint split", dict(enc_mode=8), 6, dict(patches=True), "split"),
    ("CPU checkpoint on the card",
     dict(enc_mode=8, rate_control_mode=1, target_bitrate=600_000,
          look_ahead_distance=0), 6, dict(patches=True), "ckpt_cpu"),
    ("EncoderHandle", dict(enc_mode=8), 5, dict(patches=True), "handle"),
    ("speed control", dict(enc_mode=7), 6, dict(patches=True), "speed"),
)

# H100 SXM peaks (NVIDIA data sheet): HBM rate and non-tensor fp32 rate;
# int32 multiply-adds are counted at the fp32 rate (no lower bound is
# tighter than the fastest ALU rate)
HBM_BYTES_PER_S = 3.35e12
ALU_OPS_PER_S = 67e12


def log(msg: str) -> None:
    print(msg, flush=True)


def make_frames(n, w, h, seed=7, patches=False, bit_depth=8,
                chroma_format=1, noise=0.0):
    """Synthetic content: textured luma and chroma with a global pan and a
    moving object (the repository benchmark's generator). patches: every
    odd picture gets (w // 256) * (h // 256) new 64x64 smooth ramps of
    seeded slope, direction and place, which no reference holds (intra
    CUs at M8-M9; the even pictures show what a picture without them
    costs). bit_depth 10: the samples times 4 plus seeded 2-bit noise, as
    uint16. noise: seeded Gaussian noise of that standard deviation on
    the 8-bit luma (a source the denoiser filters). chroma_format 2 / 3:
    the 4:2:0 chroma rows (and columns) repeated to 4:2:2 / 4:4:4."""
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
        if patches and i % 2 == 1:
            prng = np.random.default_rng(seed * 1000 + i)
            a = np.arange(64)
            for _ in range(max(1, (w // 256) * (h // 256))):
                py = int(prng.integers(0, h - 64))
                px = int(prng.integers(0, w - 64))
                sy_, sx_ = prng.integers(1, 3, 2)
                ramp = np.clip(30 + np.add.outer(sy_ * a, sx_ * a), 0, 255)
                if prng.integers(0, 2):
                    ramp = ramp[::-1]
                if prng.integers(0, 2):
                    ramp = ramp[:, ::-1]
                y[py:py + 64, px:px + 64] = ramp
        if noise:
            grng = np.random.default_rng(seed * 1000 + 700 + i)
            y = np.clip(y + grng.normal(0, noise, y.shape), 0,
                        255).astype(np.uint8)
        if bit_depth == 10:
            nrng = np.random.default_rng(seed * 1000 + 500 + i)
            y, cb, cr = (p.astype(np.uint16) * 4
                         + nrng.integers(0, 4, p.shape).astype(np.uint16)
                         for p in (y, cb, cr))
        if chroma_format >= 2:
            cb, cr = np.repeat(cb, 2, 0), np.repeat(cr, 2, 0)
        if chroma_format == 3:
            cb, cr = np.repeat(cb, 2, 1), np.repeat(cr, 2, 1)
        frames.append(Frame(y=y, cb=cb, cr=cr))
    return frames


def device_ms(fn, reps: int = R_LAUNCHES) -> float:
    """Device milliseconds of one fn() call: after a warm-up call, one
    CUDA-event pair around `reps` back-to-back calls, over reps. A sleep
    kernel queued first holds the device until the host has queued every
    call, so the calls' host time does not enter; if the start event has
    already run when the last call is queued, the sleep was too short and
    the run is repeated with a longer one."""
    import torch
    fn()
    torch.cuda.synchronize()
    cycles = 1 << 25
    for _ in range(6):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        ahead = not a.query()
        b.synchronize()
        if ahead:
            return a.elapsed_time(b) / reps
        cycles *= 4
    raise SystemExit("FAIL: the host cannot queue the timed calls ahead "
                     "of the device")


def call_ms(fn, reps: int) -> float:
    """Host-inclusive milliseconds of one fn() call: the median over reps
    of an event pair around a single call, each followed by a
    synchronize, so the span holds the wrapper's host work too."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def bound(nbytes: float, ops: float):
    t_b = nbytes / HBM_BYTES_PER_S * 1e3
    t_o = ops / ALU_OPS_PER_S * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SystemExit(f"FAIL: {what}")


def phase_card():
    import torch
    t0 = time.perf_counter()
    check(torch.cuda.is_available(), "torch.cuda.is_available() is false")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    log(f"phase card: {torch.cuda.get_device_name(0)}, "
        f"torch {torch.__version__}, cuda {torch.version.cuda}, "
        f"python {sys.version.split()[0]} "
        f"({time.perf_counter() - t0:.3f} s)")
    return card


def phase_build():
    from svt_hevc_tpu_torch.gpu import kernels
    from svt_hevc_tpu_torch.pipeline.native_emit import native_emit_available
    t0 = time.perf_counter()
    secs = kernels.build_all()
    for k in kernels.KERNELS:
        rows = kernels.ptxas_summary(k.build_log)
        check(bool(rows), f"{k.source}: no ptxas report in the build log")
        for row in rows:
            log(f"  {k.source} {row}")
    # without the C emitter the host walk falls back to the Python one:
    # the same bytes, but every time below would time that slower path
    check(native_emit_available(),
          "the native host emitter (native/*.c) did not build")
    log(f"phase build: {len(kernels.KERNELS)} kernels built with nvcc "
        f"for sm_90a in {secs:.3f} s, native host emitter built "
        f"({time.perf_counter() - t0:.3f} s)")


def _kernel_inputs(dev):
    """1080p main-path inputs: two consecutive frames, padded to the
    64-aligned grid like the encoder's upload."""
    from svt_hevc_tpu_torch.gpu import encode as genc
    fr = make_frames(2, 1920, 1080, seed=7)
    return [genc.prep_planes(f.y, f.cb, f.cr, 1920, 1088, dev) for f in fr]


def k1_levels(planes):
    """K1's inputs at the three hme_search levels: (name, src, ref, r)."""
    from svt_hevc_tpu_torch.gpu.me import _decimate2
    (y0, _, _), (y1, _, _) = planes
    s0, r0 = y1.float(), y0.float()
    s1, r1 = _decimate2(s0), _decimate2(r0)
    s2, r2 = _decimate2(s1), _decimate2(r1)
    return [("level2", s2, r2, 8), ("level1", s1, r1, 4),
            ("level0", s0, r0, 4)]


def k1_work(src, r):
    """(bytes, operations) K1 must move and do: src and ref read once,
    the field written once; sub, abs, add per sample and displacement."""
    h, w = src.shape
    s2n = (2 * r + 1) ** 2
    return 4 * (2 * h * w + s2n * (h // 16) * (w // 16)), 3.0 * h * w * s2n


def k2_fields(k, nby, nbx, seed=5):
    """(k, nby, nbx, 2) int32 MV fields over the whole range: random,
    exactly at the clamp (+-(PAD-9)*4) and beyond it."""
    from svt_hevc_tpu_torch.gpu import encode as genc
    rng = np.random.default_rng(seed)
    lim = (genc.PAD - 9) * 4
    mv = rng.integers(-lim - 64, lim + 65, (k, nby, nbx, 2)).astype(np.int32)
    mv[:, 0, :, :] = lim
    mv[:, -1, :, :] = -lim
    mv[:, :, 0, 0] = lim + 40
    mv[:, :, -1, 1] = -lim - 40
    return mv


def k2_work(ext, maps, n, taps):
    """(bytes, operations) of one K2 call: every plane read once, the four
    maps read once, the int32 output written once; the multiply-adds of
    both passes at two operations each."""
    n_planes = ext.shape[0] if ext.dim() == 3 else 1
    hp, wp = ext.shape[-2:]
    n_fields = maps[0].shape[0] if maps[0].dim() == 3 else 1
    nby, nbx = maps[0].shape[-2:]
    nb = nby * nbx
    m = n + taps - 1
    outs = n_planes * n_fields * nb * n * n
    nbytes = 4 * (n_planes * hp * wp + 4 * n_fields * nb + outs)
    return nbytes, 2.0 * n_planes * n_fields * nb * taps * (m * n + n * n)


def k2_args(genc, comp, ext, mv8c, rounded, bd):
    """mc_block's arguments for clamped MV field(s) on ext."""
    if comp == "luma":
        maps, n, taps, pad = genc._luma_maps(mv8c), 8, 8, genc.PAD
    else:
        maps, n, taps, pad = genc._chroma_maps(mv8c), 4, 4, genc.PAD // 2
    return (ext, *(m.contiguous() for m in maps), n, taps, pad, rounded,
            bd)


def time_kernel(fn, plain, nbytes, ops, plain_reps=3):
    """device_ms, call_ms, plain call_ms and the bound of one variant."""
    b, by = bound(nbytes, ops)
    return {"device_ms": device_ms(fn), "call_ms": call_ms(fn, 50),
            "plain_ms": call_ms(plain, plain_reps),
            "bound_ms": b, "bound_by": by}


def _fmt(t):
    return (f"device {t['device_ms']:.4f} ms, call {t['call_ms']:.4f} ms, "
            f"plain {t['plain_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms "
            f"by {t['bound_by']} ({t['bound_ms'] / t['device_ms']:.0%} of "
            f"bound)")


def phase_kernels(results: dict):
    import torch
    from svt_hevc_tpu_torch.gpu import encode as genc
    from svt_hevc_tpu_torch.gpu import kernels as K

    t0 = time.perf_counter()
    dev = torch.device("cuda")
    planes = _kernel_inputs(dev)
    (y0, cb0, cr0), _ = planes
    max_err = {"sad_field": 0.0, "mc_block": 0.0}

    # ---- K1 at the three hme_search levels
    k1 = {"device_ms": 0.0, "call_ms": 0.0, "plain_ms": 0.0, "ops": 0.0,
          "bytes": 0.0}
    for name, src, ref, r in k1_levels(planes):
        out = K.sad_field(src, ref, 16, r)
        want = K.sad_field_ref(src, ref, 16, r)
        torch.cuda.synchronize()
        check(torch.equal(out, want), f"K1 {name} differs from plain")
        max_err["sad_field"] = max(max_err["sad_field"],
                                   float((out - want).abs().max()))
        nbytes, ops = k1_work(src, r)
        t = time_kernel(lambda a=(src, ref, 16, r): K.sad_field(*a),
                        lambda a=(src, ref, 16, r): K.sad_field_ref(*a),
                        nbytes, ops)
        h, w = src.shape
        log(f"  K1 sad_field {name} {h}x{w} r={r}: equal, {_fmt(t)}")
        for key in ("device_ms", "call_ms", "plain_ms"):
            k1[key] += t[key]
        k1["ops"] += ops
        k1["bytes"] += nbytes

    # ---- K1 at 10-bit: the same levels of the two frames at 10-bit
    # (samples times 4 plus 3); float32 sums stay exact (64*64*1023 <
    # 2^24)
    planes10 = [tuple((p << 2) + 3 for p in fr) for fr in planes]
    k1_10 = {"device_ms": 0.0, "call_ms": 0.0, "plain_ms": 0.0, "ops": 0.0,
             "bytes": 0.0}
    for name, src, ref, r in k1_levels(planes10):
        out = K.sad_field(src, ref, 16, r)
        want = K.sad_field_ref(src, ref, 16, r)
        torch.cuda.synchronize()
        check(torch.equal(out, want), f"K1 10-bit {name} differs from plain")
        max_err["sad_field"] = max(max_err["sad_field"],
                                   float((out - want).abs().max()))
        nbytes, ops = k1_work(src, r)
        t = time_kernel(lambda a=(src, ref, 16, r): K.sad_field(*a),
                        lambda a=(src, ref, 16, r): K.sad_field_ref(*a),
                        nbytes, ops)
        log(f"  K1 sad_field 10-bit {name} r={r}: equal, {_fmt(t)}")
        for key in ("device_ms", "call_ms", "plain_ms"):
            k1_10[key] += t[key]
        k1_10["ops"] += ops
        k1_10["bytes"] += nbytes

    # ---- K2 on one field: luma / chroma, rounded both ways, 8- and
    # 10-bit, MVs at and beyond the clamp (the wrapper path with its
    # clamp against the plain direct forms)
    lim = (genc.PAD - 9) * 4
    nby, nbx = 1088 // 8, 1920 // 8
    mv8 = torch.from_numpy(k2_fields(1, nby, nbx)[0]).to(dev)
    mv8c = mv8.clamp(-lim, lim)
    exts = {}
    for bd in (8, 10):
        ly = y0 if bd == 8 else (y0 << 2) + 3
        lc = torch.stack([cb0, cr0]) if bd == 8 else \
            (torch.stack([cb0, cr0]) << 2) + 1
        exts[bd] = (genc._ext_y(ly), genc._ext_c(lc))
        ext_y, ext_c2 = exts[bd]
        for rounded in (False, True):
            for comp, ext in (("luma", ext_y), ("chroma", ext_c2[0])):
                if comp == "luma":
                    out = genc._mc_luma(ext, mv8, bd, rounded)
                    want = (genc._mc_pred_luma_direct if rounded
                            else genc._mc_raw_luma_direct)(ext, mv8c, bd)
                else:
                    out = genc._mc_chroma(ext, mv8, bd, rounded)
                    want = (genc._mc_pred_chroma_direct if rounded
                            else genc._mc_raw_chroma_direct)(ext, mv8c, bd)
                torch.cuda.synchronize()
                check(torch.equal(out, want),
                      f"K2 {comp} bd={bd} rounded={rounded} differs")
                max_err["mc_block"] = max(
                    max_err["mc_block"], float((out - want).abs().max()))
                args = k2_args(genc, comp, ext, mv8c, rounded, bd)
                nbytes, ops = k2_work(ext, args[1:5], *args[5:7])
                t = time_kernel(lambda a=args: K.mc_block(*a),
                                lambda a=args: K.mc_block_ref(*a),
                                nbytes, ops)
                hp, wp = ext.shape
                log(f"  K2 mc_block {comp} bd={bd} rounded={rounded} "
                    f"ref_ext {hp}x{wp} -> {out.shape[0]}x{out.shape[1]}: "
                    f"equal, {_fmt(t)}")

    # ---- K2 batched as the callers launch it: K=10 luma fields on one
    # plane (merge_snap's launch) and Cb + Cr under one field (the encode
    # pass), rounded both ways, 8- and 10-bit
    mv10 = torch.from_numpy(k2_fields(10, nby, nbx, seed=6)).to(dev)
    mv10c = mv10.clamp(-lim, lim)
    k2, k2_10 = None, None
    for bd in (8, 10):
        ext_y, ext_c2 = exts[bd]
        for rounded in (False, True):
            for comp, ext, mv, mvc in (("luma", ext_y, mv10, mv10c),
                                       ("chroma", ext_c2, mv8, mv8c)):
                fn = genc._mc_luma if comp == "luma" else genc._mc_chroma
                out = fn(ext, mv, bd, rounded)
                args = k2_args(genc, comp, ext, mvc, rounded, bd)
                want = K.mc_block_ref(*args)
                torch.cuda.synchronize()
                check(tuple(out.shape) == tuple(want.shape)
                      and torch.equal(out, want),
                      f"K2 batched {comp} bd={bd} rounded={rounded} "
                      f"differs")
                max_err["mc_block"] = max(
                    max_err["mc_block"], float((out - want).abs().max()))
                if not rounded or (bd == 10 and comp != "luma"):
                    continue
                nbytes, ops = k2_work(ext, args[1:5], *args[5:7])
                t = time_kernel(lambda a=args: K.mc_block(*a),
                                lambda a=args: K.mc_block_ref(*a),
                                nbytes, ops, plain_reps=2)
                shape = "x".join(map(str, out.shape))
                log(f"  K2 mc_block batched {comp} bd={bd} rounded -> "
                    f"{shape}: equal, {_fmt(t)}")
                if comp == "luma":
                    if bd == 8:
                        k2 = t
                    else:
                        k2_10 = t
    # random fields share no window between neighbouring blocks; a field
    # of one MV per 32x32 CU (as the decided fields mostly are) does
    mv32 = mv10c[:, ::4, ::4].repeat_interleave(4, 1).repeat_interleave(
        4, 2).contiguous()
    args = k2_args(genc, "luma", exts[8][0], mv32, True, 8)
    check(torch.equal(K.mc_block(*args), K.mc_block_ref(*args)),
          "K2 batched luma, one MV per 32x32, differs")
    log(f"  K2 mc_block batched luma bd=8 rounded, one MV per 32x32 block: "
        f"equal, device {device_ms(lambda: K.mc_block(*args)):.4f} ms")
    # ---- K2 as the B path launches it: merge_snap_b's unrounded luma
    # launch (the decided field and the A1 / B1 fields of the three CU
    # sizes of CTB 32, K=7) on one list's plane
    mv7 = mv10[:7].contiguous()
    args = k2_args(genc, "luma", exts[8][0], mv10c[:7].contiguous(), False,
                   8)
    out = genc._mc_luma(exts[8][0], mv7, 8, False)
    want = K.mc_block_ref(*args)
    torch.cuda.synchronize()
    check(torch.equal(out, want), "K2 B-shaped luma K=7 14-bit differs")
    max_err["mc_block"] = max(max_err["mc_block"],
                              float((out - want).abs().max()))
    nbytes, ops = k2_work(exts[8][0], args[1:5], *args[5:7])
    k2b = time_kernel(lambda a=args: K.mc_block(*a),
                      lambda a=args: K.mc_block_ref(*a), nbytes, ops,
                      plain_reps=2)
    log(f"  K2 mc_block B-shaped luma bd=8 14-bit K=7 (merge_snap_b) -> "
        f"{'x'.join(map(str, out.shape))}: equal, {_fmt(k2b)}")
    b1, by1 = bound(k1["bytes"], k1["ops"])
    b10, by10 = bound(k1_10["bytes"], k1_10["ops"])
    results["sad_field"] = {
        "device_ms": k1["device_ms"], "call_ms": k1["call_ms"],
        "plain_ms": k1["plain_ms"], "bound_ms": b1, "bound_by": by1,
        "max_abs_err": max_err["sad_field"],
        "bd10": {"device_ms": k1_10["device_ms"],
                 "call_ms": k1_10["call_ms"],
                 "plain_ms": k1_10["plain_ms"], "bound_ms": b10,
                 "bound_by": by10}}
    results["mc_block"] = dict(k2, max_abs_err=max_err["mc_block"],
                               b_launch=k2b, bd10=k2_10)
    log(f"phase kernels: K1 x3 levels at 8 and 10 bits, K2 x8 one-field, "
        f"x8 batched and the B-shaped variant equal to plain; device_ms "
        f"over "
        f"{R_LAUNCHES} launches "
        f"({time.perf_counter() - t0:.3f} s)")


def _cfg(w, h, **kw):
    """The small clips' config: qp 32, M7, intra_period=-1, 50 fps unless
    kw says otherwise."""
    from svt_hevc_tpu_torch import EncoderConfig
    return EncoderConfig(**dict(dict(width=w, height=h, qp=32, enc_mode=7,
                                     intra_period=-1, fps_num=50), **kw))


def _encode(frames, w, h, device, n_aus=None, **kw):
    """Encode frames (_cfg's config); with n_aus, take only the stream's
    first n_aus access units from the generator and stop. Returns
    (parameter-set headers, access units)."""
    return _encode_cfg(_cfg(w, h, **kw), frames, device, n_aus)


def _encode_cfg(cfg, frames, device, n_aus=None):
    from svt_hevc_tpu_torch import Encoder
    enc = Encoder(cfg, device=device)
    gen = enc.encode_pictures(frames)
    aus = []
    for au in gen:
        aus.append(au)
        if len(aus) == n_aus:
            gen.close()
            break
    return enc.headers(), aus


def cpu_reference(job):
    """One CPU reference encode, run in a worker process. job = dict:
    frames (n, width, height, make_frames seed, make_frames arguments),
    kw (the config), n_aus, mode (plain; speed: speed control toward 1e9
    fps; ckpt_cpu: also the first 3 pictures' access units and the
    pickled checkpoint after them; cli: the config the command line's
    tokens select). Returns (headers, access-unit bytes, seconds, extra)."""
    import pickle

    import torch
    from svt_hevc_tpu_torch import Encoder, EncoderConfig
    torch.set_num_threads(CPU_THREADS)
    n, w, h, seed, fkw = job["frames"]
    t0 = time.perf_counter()
    frames = make_frames(n, w, h, seed=seed, **fkw)
    mode = job.get("mode", "plain")
    extra = None
    if mode == "cli":
        from svt_hevc_tpu_torch import app
        cfg = app.config_from_args(app.build_parser().parse_args(
            ["-i", "-", "-b", "-", *CLI_TOKENS]), w, h)
        hdr, aus = _encode_cfg(cfg, frames, "cpu", n_aus=job["n_aus"])
    elif mode == "speed":
        enc = Encoder(_cfg(w, h, **job["kw"]), device="cpu")
        enc.set_speed_control(1e9)
        hdr, aus = enc.headers(), list(enc.encode_pictures(frames))
        extra = enc._dyn_enc_mode
    elif mode == "sov":
        hdr, aus = _encode(_with_segment_ov(frames, w, h), w, h, "cpu",
                           **job["kw"])
    else:
        hdr, aus = _encode(frames, w, h, "cpu", n_aus=job.get("n_aus"),
                           **job["kw"])
        if mode == "ckpt_cpu":
            enc = Encoder(_cfg(w, h, **job["kw"]), device="cpu")
            head = [a.data for a in enc.encode_pictures(frames[:3])]
            extra = (head, pickle.dumps(enc.checkpoint()))
    return hdr, [a.data for a in aus], time.perf_counter() - t0, extra


def cpu_jobs() -> dict:
    """Every check's CPU reference, longest first (the order the workers
    take them in)."""
    def job(n, w, h, seed, kw, n_aus=None, fkw=None, mode="plain"):
        return {"frames": (n, w, h, seed, fkw or {}), "kw": kw,
                "n_aus": n_aus, "mode": mode}

    jobs = {"ra": job(5, 1920, 1080, 7, dict(RA_KW, fps_num=50), 3),
            "cli": job(CLI_FRAMES, 1920, 1080, 7, {}, 2,
                       dict(patches=True, bit_depth=10), "cli"),
            "main": job(2, 1920, 1080, 7, dict(fps_num=50)),
            "small": job(10, 512, 256, 11, {}),
            "small_ra": job(9, 512, 256, 11, RA_KW)}
    for name, (kw, n, fkw, _, _) in SMALL_NEW.items():
        jobs[name] = job(n, 512, 256, 11, kw, fkw=fkw)
    for i, (kw, n) in sorted(enumerate(VARIANTS), key=lambda e: -e[1][1]):
        jobs[f"variant{i}"] = job(n, 512, 256, 11, kw)
    for i, (_, kw, n, fkw, mode) in enumerate(STREAM_VARIANTS):
        jobs[f"stream_variant{i}"] = job(n, 512, 256, 11, kw, fkw=fkw,
                                    mode=mode)
    for name, (kw, n, fkw, w, h, _, _) in SMALL_HOST.items():
        jobs[name] = job(n, w, h, 11, kw, fkw=fkw)
    for i, (_, kw, n, fkw, w, h, mode) in enumerate(HOST_VARIANTS):
        jobs[f"host_variant{i}"] = job(n, w, h, 11, kw, fkw=fkw, mode=mode)
    return jobs


def _with_segment_ov(frames, w, h):
    """Per-CTB segment overrides (CTB 32) on the first and third
    pictures: a direct QP, a delta QP and a deblock-density delta."""
    from svt_hevc_tpu_torch.config import (SEG_DENSITY_DEBLOCK_OV,
                                           SEG_DENSITY_QP_OV,
                                           SEG_QP_OV_DELTA,
                                           SEG_QP_OV_DIRECT)
    sov = np.zeros(((h + 31) // 32, (w + 31) // 32, 3), np.int32)
    sov[0, 0] = (SEG_DENSITY_QP_OV | SEG_QP_OV_DIRECT, 20, 0)
    sov[1, 2] = (SEG_DENSITY_QP_OV | SEG_QP_OV_DELTA, 6, 0)
    sov[-1, -1] = (SEG_DENSITY_DEBLOCK_OV, 0, -4)
    for i in (0, 2):
        frames[i].segment_ov = sov
    return frames


def _decodes_to_recon(stream: bytes, aus, what: str) -> None:
    """The port's decoder gives back every picture's recon (the decoder
    outputs in display order)."""
    from svt_hevc_tpu_torch.decoder.decoder import decode_stream
    dec = decode_stream(stream)
    check(len(dec) == len(aus), f"{what}: decoded picture count")
    for d, a in zip(dec, sorted(aus, key=lambda a: a.display_idx)):
        check(np.array_equal(d.y, a.recon.y)
              and np.array_equal(d.cb, a.recon.cb)
              and np.array_equal(d.cr, a.recon.cr),
              f"{what}: decoded != recon")


def _psnr(recons, frames, peak: float = 255.0) -> float:
    se = 0.0
    npx = 0
    for rec, fr in zip(recons, frames):
        d = np.asarray(rec.y, np.float64) - fr.y.astype(np.float64)
        se += float((d * d).sum())
        npx += d.size
    return 10 * np.log10(peak ** 2 * npx / max(se, 1e-9))


def phase_small(cpu):
    t0 = time.perf_counter()
    frames = make_frames(10, 512, 256, seed=11)
    hdr, aus = _encode(frames, 512, 256, "cuda")
    s_gpu = hdr + b"".join(a.data for a in aus)
    t1 = time.perf_counter()
    hdr_c, aus_c, t_cpu, _ = cpu.result()
    check(s_gpu == hdr_c + b"".join(aus_c),
          "small clip: card stream != CPU stream")
    sha = hashlib.sha256(s_gpu).hexdigest()
    check(sha == SMALL_SHA256 and len(s_gpu) == SMALL_BYTES,
          f"small clip: sha256 {sha} / {len(s_gpu)} bytes != reference")
    _decodes_to_recon(s_gpu, aus, "small clip")
    log(f"phase small: 512x256 x10 {len(s_gpu)} bytes, sha256 match, "
        f"card == CPU, decode == recon, PSNR-Y "
        f"{_psnr([a.recon for a in aus], frames):.3f} dB; card "
        f"{t1 - t0:.3f} s, CPU {t_cpu:.3f} s in a worker "
        f"({time.perf_counter() - t0:.3f} s)")


def phase_small_ra(cpu):
    t0 = time.perf_counter()
    frames = make_frames(9, 512, 256, seed=11)
    hdr, aus = _encode(frames, 512, 256, "cuda", **RA_KW)
    s_gpu = hdr + b"".join(a.data for a in aus)
    t1 = time.perf_counter()
    hdr_c, aus_c, t_cpu, _ = cpu.result()
    check(s_gpu == hdr_c + b"".join(aus_c),
          "small RA clip: card stream != CPU stream")
    sha = hashlib.sha256(s_gpu).hexdigest()
    check(sha == SMALL_RA_SHA256 and len(s_gpu) == SMALL_RA_BYTES,
          f"small RA clip: sha256 {sha} / {len(s_gpu)} bytes != reference")
    _decodes_to_recon(s_gpu, aus, "small RA clip")
    types = "".join("IPB"[2 - a.slice_type] for a in aus)
    recons = [a.recon for a in sorted(aus, key=lambda a: a.display_idx)]
    log(f"phase small_ra: 512x256 x9 RA hl=2 (decode order {types}) "
        f"{len(s_gpu)} bytes, sha256 match, card == CPU, decode == recon, "
        f"PSNR-Y {_psnr(recons, frames):.3f} dB; "
        f"card {t1 - t0:.3f} s, CPU {t_cpu:.3f} s in a worker "
        f"({time.perf_counter() - t0:.3f} s)")


def phase_variants(cpus):
    t0 = time.perf_counter()
    frames = make_frames(9, 512, 256, seed=11)
    parts = []
    for (kw, n), cpu in zip(VARIANTS, cpus):
        name = ",".join(f"{k}={v}" for k, v in kw.items())
        hdr, aus = _encode(frames[:n], 512, 256, "cuda", **kw)
        s_gpu = hdr + b"".join(a.data for a in aus)
        hdr_c, aus_c, _, _ = cpu.result()
        check(s_gpu == hdr_c + b"".join(aus_c),
              f"variant {name}: card stream != CPU stream")
        _decodes_to_recon(s_gpu, aus, f"variant {name}")
        parts.append(f"{name} x{n} {len(s_gpu)} bytes")
    log(f"phase variants: 512x256, card == CPU, decode == recon: "
        f"{'; '.join(parts)} ({time.perf_counter() - t0:.3f} s)")


def phase_main(results: dict):
    import torch
    from svt_hevc_tpu_torch import Encoder, EncoderConfig
    from svt_hevc_tpu_torch.gpu import kernels as K

    t_phase = time.perf_counter()
    n = 5
    frames = make_frames(n, 1920, 1080, seed=7)
    cfg = EncoderConfig(width=1920, height=1080, qp=32, fps_num=50,
                        enc_mode=7, intra_period=-1)
    enc = Encoder(cfg)
    names = [k.name for k in K.KERNELS]

    def counts():
        return np.array([k.launches for k in K.KERNELS])

    torch.cuda.synchronize()
    K.reset_launches()
    c_start = counts()
    snaps, times, aus = [], [], []
    t0 = time.perf_counter()
    for au in enc.encode_pictures(iter(frames)):
        times.append(time.perf_counter())
        snaps.append(counts())
        aus.append(au)
    totals = counts() - c_start
    # frames k >= 1 dispatch between the yields of AU k-2 and AU k-1
    # (frames 0 and 1 both before AU 0; the I picture launches neither
    # kernel)
    per_p = [snaps[0] - c_start] + [snaps[k - 1] - snaps[k - 2]
                                    for k in range(2, n)]
    for i, c in enumerate(per_p, start=1):
        check(all(c > 0), f"P picture {i}: launches {dict(zip(names, c))}")
    for k, name in enumerate(names):
        results[name]["launches"] = int(totals[k])
    idr = times[0] - t0
    first_p = times[1] - times[0]
    steady = (times[-1] - times[1]) / (n - 2)
    psnr = _psnr([a.recon for a in aus], frames)
    log(f"  1080p: IDR {idr:.3f} s, first P {first_p:.3f} s, steady P "
        f"{steady:.3f} s/frame ({1.0 / steady:.3f} fps), PSNR-Y "
        f"{psnr:.3f} dB, {sum(len(a.data) for a in aus)} bytes, native "
        f"host emitter")
    log("  launches per P picture: " + ", ".join(
        f"{name} {[int(c[k]) for c in per_p]}"
        for k, name in enumerate(names)))
    log(f"phase main: 1920x1080 x{n} IPPP on the card "
        f"({time.perf_counter() - t_phase:.3f} s)")
    return aus


def phase_ra(results: dict):
    import torch
    from svt_hevc_tpu_torch import Encoder, EncoderConfig
    from svt_hevc_tpu_torch.gpu import kernels as K

    t_phase = time.perf_counter()
    n = 5
    frames = make_frames(n, 1920, 1080, seed=7)
    cfg = EncoderConfig(width=1920, height=1080, qp=32, fps_num=50,
                        enc_mode=7, intra_period=-1, **RA_KW)
    enc = Encoder(cfg)
    names = [k.name for k in K.KERNELS]

    def counts():
        return np.array([k.launches for k in K.KERNELS])

    # random access encodes one picture per access unit (no pipelining):
    # the time and the launches between two yields are that picture's
    torch.cuda.synchronize()
    K.reset_launches()
    c_start = counts()
    rows, aus = [], []
    t_prev, c_prev = time.perf_counter(), c_start
    for au in enc.encode_pictures(iter(frames)):
        t_now, c_now = time.perf_counter(), counts()
        pos = au.poc % 4
        layer = 0 if pos == 0 else 2 - ((pos & -pos).bit_length() - 1)
        rows.append((au, layer, t_now - t_prev, c_now - c_prev))
        aus.append(au)
        t_prev, c_prev = t_now, c_now
    totals = counts() - c_start
    per_b = [c for au, _, _, c in rows if au.slice_type == 0]
    check(len(per_b) == 3, f"RA: {len(per_b)} B pictures, not 3")
    for i, c in enumerate(per_b):
        check(all(c > 0), f"B picture {i}: launches {dict(zip(names, c))}")
    for k, name in enumerate(names):
        results[name]["launches_ra"] = int(totals[k])
        results[name]["launches_per_b_picture"] = [int(c[k]) for c in per_b]
    order = " ".join(f"{'IPB'[2 - au.slice_type]}{au.poc}"
                     for au, _, _, _ in rows)
    idr = rows[0][2]
    p_s = [dt for au, _, dt, _ in rows if au.slice_type == 1]
    b_s = {}
    for au, layer, dt, _ in rows:
        if au.slice_type == 0:
            b_s.setdefault(layer, []).append(dt)
    recons = [a.recon for a in sorted(aus, key=lambda a: a.display_idx)]
    psnr = _psnr(recons, frames)
    log(f"  1080p RA hl=2 decode order {order}: IDR {idr:.3f} s, P anchors "
        f"{', '.join(f'{t:.3f}' for t in p_s)} s, "
        + ", ".join(f"layer-{lv} B {', '.join(f'{t:.3f}' for t in ts)} s "
                    f"(mean {np.mean(ts):.3f})"
                    for lv, ts in sorted(b_s.items()))
        + f"; PSNR-Y {psnr:.3f} dB, {sum(len(a.data) for a in aus)} bytes")
    log("  launches per B picture: " + ", ".join(
        f"{name} {[int(c[k]) for c in per_b]}"
        for k, name in enumerate(names)))
    check([(a.poc, a.slice_type) for a in aus[:3]]
          == [(0, 2), (4, 1), (2, 0)],
          "RA: the first three access units are not I0, P4, B2")
    log(f"phase ra: 1920x1080 x{n} RA on the card "
        f"({time.perf_counter() - t_phase:.3f} s)")
    return aus



class _FixupTimer:
    """gpu.encode.STAGE_TIMER of the command-line probe: the wall seconds
    the host waits in the intra fixup's any_intra read (no synchronize
    around it: the wait is the device work still queued) and the
    seconds of the fixup's wavefront (synchronized before and after);
    every other stage runs as without the hook."""

    def __init__(self):
        self.wait = 0.0
        self.wavefront = 0.0

    def stage(self, name: str):
        import contextlib

        import torch
        kind = name.split(".", 1)[1]

        @contextlib.contextmanager
        def timed():
            if kind == "intra_wavefront_pass":
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            yield
            if kind == "intra_wavefront_pass":
                torch.cuda.synchronize()
                self.wavefront += time.perf_counter() - t0
            elif kind == "any_intra":
                self.wait += time.perf_counter() - t0
        return timed()


def _counts():
    from svt_hevc_tpu_torch.gpu import intra_pass
    from svt_hevc_tpu_torch.gpu import kernels as K
    return ([k.launches for k in K.KERNELS]
            + [intra_pass.WAVEFRONT["runs"], intra_pass.WAVEFRONT["steps"]])


def cli_probe(out_path: str, tokens) -> int:
    """The command line's main (what python -m svt_hevc_tpu_torch.app
    runs) with a probe around Encoder.encode_pictures: per access unit
    in decode order, the seconds since the previous one (the first: since
    the call, so it holds the first lookahead batch), the kernel launches
    and the intra wavefront runs and steps in between, and the intra
    fixup's seconds (_FixupTimer). VBR pictures are not pipelined, so
    each span is that picture's. Counts start at 0 when the encode
    starts."""
    import torch
    from svt_hevc_tpu_torch import app
    from svt_hevc_tpu_torch.gpu import encode as genc
    from svt_hevc_tpu_torch.gpu import intra_pass
    from svt_hevc_tpu_torch.gpu import kernels as K
    from svt_hevc_tpu_torch.pipeline.encoder import Encoder

    rows = []
    encode_pictures = Encoder.encode_pictures
    timer = genc.STAGE_TIMER = _FixupTimer()

    def probed(self, frames, **kw):
        torch.cuda.synchronize()
        K.reset_launches()
        intra_pass.WAVEFRONT.update(runs=0, steps=0)
        t_prev, c_prev = time.perf_counter(), _counts()
        f_prev = (timer.wait, timer.wavefront)
        for au in encode_pictures(self, frames, **kw):
            t_now, c_now = time.perf_counter(), _counts()
            rows.append({"poc": au.poc, "slice_type": au.slice_type,
                         "seconds": t_now - t_prev,
                         "counts": [b - a for a, b in zip(c_prev, c_now)],
                         "any_intra_wait": timer.wait - f_prev[0],
                         "wavefront_s": timer.wavefront - f_prev[1]})
            t_prev, c_prev = t_now, c_now
            f_prev = (timer.wait, timer.wavefront)
            yield au

    Encoder.encode_pictures = probed
    rc = app.main(list(tokens))
    with open(out_path, "w") as f:
        json.dump(rows, f)
    return rc


def _slice_qps(stream: bytes) -> list[int]:
    """slice_qp of every slice, in stream order."""
    from svt_hevc_tpu_torch.bitstream.bitwriter import ebsp_to_rbsp
    from svt_hevc_tpu_torch.bitstream.headers import (parse_pps,
                                                      parse_slice_header,
                                                      parse_sps)
    from svt_hevc_tpu_torch.bitstream.nal import split_annexb
    sps = pps = None
    qps = []
    for t, e in split_annexb(stream):
        rbsp = ebsp_to_rbsp(e)
        if t == 33:
            sps = parse_sps(rbsp)
        elif t == 34:
            pps = parse_pps(rbsp)
        elif t < 32:
            qps.append(parse_slice_header(rbsp, int(t), sps, pps).slice_qp)
    return qps


def _time_lookahead(ys) -> float:
    """Seconds of one lookahead_stats call on the card (median of 3,
    synchronized)."""
    import torch
    from svt_hevc_tpu_torch.gpu.analysis import lookahead_stats
    lookahead_stats(ys)
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lookahead_stats(ys)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return float(np.median(times))


def phase_cli_1080p(results: dict):
    import torch
    from svt_hevc_tpu_torch.decoder.decoder import decode_stream
    from svt_hevc_tpu_torch.gpu.analysis import lookahead_stats
    from svt_hevc_tpu_torch.gpu import kernels as K
    from svt_hevc_tpu_torch.io.yuv import read_yuv, write_yuv420

    t_phase = time.perf_counter()
    n = CLI_FRAMES
    frames = make_frames(n, 1920, 1080, seed=7, patches=True, bit_depth=10)
    d = os.path.join(HERE, "build", "cli_1080p")
    os.makedirs(d, exist_ok=True)
    path = {k: os.path.join(d, k)
            for k in ("in.yuv", "out.265", "rec.yuv", "probe.json")}
    write_yuv420(path["in.yuv"], frames)
    tokens = ["-i", path["in.yuv"], "-b", path["out.265"], "-o",
              path["rec.yuv"], *CLI_TOKENS]
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, os.path.abspath(__file__),
                        "--cli-probe", path["probe.json"], "--", *tokens],
                       capture_output=True, text=True, timeout=900,
                       cwd=HERE)
    t_cli = time.perf_counter() - t0
    check(r.returncode == 0, f"the command line failed: {r.stderr[-3000:]}")
    with open(path["probe.json"]) as f:
        rows = json.load(f)
    with open(path["out.265"], "rb") as f:
        stream = f.read()
    recons = list(read_yuv(path["rec.yuv"], 1920, 1080, bit_depth=10))
    check(len(rows) == n and len(recons) == n,
          f"cli_1080p: {len(rows)} access units, {len(recons)} recons")
    dec = decode_stream(stream)
    check(len(dec) == n, "cli_1080p: decoded picture count")
    for dd, rr in zip(dec, recons):
        check(np.array_equal(dd.y, rr.y) and np.array_equal(dd.cb, rr.cb)
              and np.array_equal(dd.cr, rr.cr),
              "cli_1080p: decoded != recon")
    names = [k.name for k in K.KERNELS]
    nk = len(names)
    p_rows = [row for row in rows if row["slice_type"] == 1]
    check(len(p_rows) == n - 1 and rows[0]["slice_type"] == 2,
          f"cli_1080p: not one IDR and {n - 1} P pictures")
    for row in p_rows:
        check(all(c > 0 for c in row["counts"][:nk]),
              f"cli_1080p P{row['poc']}: launches {row['counts'][:nk]}")
    intra_p = [(row["poc"], row["counts"][nk + 1]) for row in p_rows
               if row["counts"][nk] > 0]
    check(len(intra_p) >= 1, "cli_1080p: no P picture with intra CUs")
    for k, name in enumerate(names):
        results[name]["launches_cli"] = sum(row["counts"][k]
                                            for row in rows)
        results[name]["launches_per_p_picture_m8"] = [
            row["counts"][k] for row in p_rows]
    qps = _slice_qps(stream)
    kbps = 8 * len(stream) * 50 / n / 1000.0
    psnr = _psnr(recons, frames, peak=1023.0)
    log(f"  {r.stdout.strip().splitlines()[-1]}")
    log(f"  1080p 10-bit M8 VBR via the command line ({t_cli:.3f} s in the "
        f"subprocess): IDR {rows[0]['seconds']:.3f} s (with the first "
        f"lookahead batch), P "
        + ", ".join(f"{row['seconds']:.3f}" for row in p_rows)
        + f" s; P pictures with intra CUs (POC, wavefront steps) {intra_p}")
    log("  P pictures: wavefront s "
        + ", ".join(f"{row['wavefront_s']:.3f}" for row in p_rows)
        + "; the rest of the picture s "
        + ", ".join(f"{row['seconds'] - row['wavefront_s']:.3f}"
                    for row in p_rows)
        + "; host wait in the any_intra read ms "
        + ", ".join(f"{row['any_intra_wait'] * 1e3:.1f}" for row in p_rows))
    log(f"  QP per picture {qps}; {kbps:.1f} kbit/s against -tbr "
        f"{CLI_TBR / 1000:.1f} ({kbps * 1000 / CLI_TBR:.3f} of target); "
        f"PSNR-Y {psnr:.3f} dB; {len(stream)} bytes")
    log("  launches per P picture: " + ", ".join(
        f"{name} {[row['counts'][k] for row in p_rows]}"
        for k, name in enumerate(names)))
    # the lookahead's statistics: card == CPU on this clip's batch, and
    # the card's time at 9 and 37 frames (batches of lookahead 3 and 17)
    ys = torch.from_numpy(np.stack([frames[0].y] + [f.y for f in frames])
                          .astype(np.int32))
    got = lookahead_stats(ys.cuda())
    want = lookahead_stats(ys)
    for key in ("zz_sad", "gm_sad", "gm_mv", "hist"):
        check(torch.equal(got[key].cpu(), want[key]),
              f"lookahead_stats {key}: card != CPU")
    rel = float(((got["variance"].cpu() - want["variance"]).abs()
                 / want["variance"]).max())
    check(rel <= 1e-6, f"lookahead_stats variance: card/CPU rel {rel}")
    big = ys.cuda().repeat(5, 1, 1)[:37]
    t_b, t37 = _time_lookahead(ys.cuda()), _time_lookahead(big)
    results["lookahead_stats"] = {f"s_{ys.shape[0]}": t_b, "s_37": t37}
    log(f"  lookahead_stats card == CPU (variance rel {rel:.2e}); card "
        f"{t_b * 1e3:.3f} ms per batch of {ys.shape[0]} frames, "
        f"{t37 * 1e3:.3f} ms per batch of 37")
    log(f"phase cli_1080p: 1920x1080 x{n} 10-bit M8 VBR through the command "
        f"line on the card ({time.perf_counter() - t_phase:.3f} s)")
    return stream


def _encode_counting_wavefront(name, frames, kw):
    """Card encode of one small slice clip, with the intra wavefront runs
    it made."""
    from svt_hevc_tpu_torch.gpu import intra_pass
    runs = intra_pass.WAVEFRONT["runs"]
    hdr, aus = _encode(frames, 512, 256, "cuda", **kw)
    return hdr, aus, intra_pass.WAVEFRONT["runs"] - runs


def phase_small_new(cpus):
    t0 = time.perf_counter()
    parts = []
    for name, (kw, n, fkw, sha_want, nbytes) in SMALL_NEW.items():
        frames = make_frames(n, 512, 256, seed=11, **fkw)
        hdr, aus, runs = _encode_counting_wavefront(name, frames, kw)
        s_gpu = hdr + b"".join(a.data for a in aus)
        hdr_c, aus_c, t_cpu, _ = cpus[name].result()
        check(s_gpu == hdr_c + b"".join(aus_c),
              f"{name}: card stream != CPU stream")
        sha = hashlib.sha256(s_gpu).hexdigest()
        check(sha == sha_want and len(s_gpu) == nbytes,
              f"{name}: sha256 {sha} / {len(s_gpu)} bytes != reference")
        _decodes_to_recon(s_gpu, aus, name)
        n_intra = sum(a.slice_type == 2 for a in aus)
        if name in ("small_m8", "small_m9_ra"):
            check(runs > n_intra,
                  f"{name}: no inter picture ran the intra wavefront")
        recons = [a.recon for a in sorted(aus, key=lambda a: a.display_idx)]
        psnr = _psnr(recons, frames,
                     peak=1023.0 if kw.get("bit_depth") == 10 else 255.0)
        parts.append(f"{name} x{n} {len(s_gpu)} bytes, {runs - n_intra} "
                     f"inter pictures with intra CUs, PSNR-Y {psnr:.3f} "
                     f"dB, CPU {t_cpu:.1f} s")
    log(f"phase small_new: 512x256, sha256 match, card == CPU, decode == "
        f"recon: {'; '.join(parts)} ({time.perf_counter() - t0:.3f} s)")


def phase_stream_variants(cpus):
    import pickle

    from svt_hevc_tpu_torch import Encoder, EncoderHandle
    t0 = time.perf_counter()
    parts = []
    for (name, kw, n, fkw, mode), cpu in zip(STREAM_VARIANTS, cpus):
        frames = make_frames(n, 512, 256, seed=11, **fkw)
        hdr_c, aus_c, _, extra = cpu.result()
        s_cpu = hdr_c + b"".join(aus_c)
        cfg = _cfg(512, 256, **kw)
        aus = None
        if mode == "plain":
            hdr, aus = _encode(frames, 512, 256, "cuda", **kw)
            s_gpu = hdr + b"".join(a.data for a in aus)
        elif mode == "split":
            e1 = Encoder(cfg)
            head = [a.data for a in e1.encode_pictures(frames[:3])]
            e2 = Encoder(cfg)
            e2.restore(pickle.loads(pickle.dumps(e1.checkpoint())))
            aus = list(e2.encode_pictures(frames[3:]))
            s_gpu = e2.headers() + b"".join(head + [a.data for a in aus])
            aus = None
        elif mode == "ckpt_cpu":
            head, blob = extra
            e2 = Encoder(cfg)
            e2.restore(pickle.loads(blob))
            tail = [a.data for a in e2.encode_pictures(frames[3:])]
            s_gpu = e2.headers() + b"".join(head + tail)
        elif mode == "handle":
            h = EncoderHandle(cfg, return_recon=True)
            for f in frames:
                h.send_picture(f)
            h.send_eos()
            pkts = list(h.packets())
            h.close()
            check([p.dts for p in pkts] == list(range(n)),
                  f"variant {name}: packet order")
            s_gpu = h.stream_header() + b"".join(p.data for p in pkts)
        else:                                   # speed
            enc = Encoder(cfg)
            enc.set_speed_control(1e9)
            aus = list(enc.encode_pictures(frames))
            s_gpu = enc.headers() + b"".join(a.data for a in aus)
            check(enc._dyn_enc_mode == extra == 11,
                  f"variant {name}: dynamic preset {enc._dyn_enc_mode} / "
                  f"CPU {extra}, not 11")
        check(s_gpu == s_cpu, f"variant {name}: card stream != CPU stream")
        from svt_hevc_tpu_torch.decoder.decoder import decode_stream
        check(len(decode_stream(s_gpu)) == n,
              f"variant {name}: decoded picture count")
        if aus is not None:
            _decodes_to_recon(s_gpu, aus, f"variant {name}")
        parts.append(f"{name} x{n} {len(s_gpu)} bytes")
    log(f"phase stream_variants: 512x256, card == CPU, decodes: "
        f"{'; '.join(parts)} ({time.perf_counter() - t0:.3f} s)")


class _StageSplit:
    """gpu.encode.STAGE_TIMER of phase host_1080p: the synchronized wall
    seconds of every named stage, summed per picture kind and stage."""

    def __init__(self):
        self.s: dict = {}

    def stage(self, name: str):
        import contextlib

        import torch

        @contextlib.contextmanager
        def timed():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            yield
            torch.cuda.synchronize()
            self.s.setdefault(name, []).append(time.perf_counter() - t0)
        return timed()


class _HostCapture:
    """For one encode, wraps the host path's device helpers
    (pipeline.encoder.dev_me_field, Encoder._ois_maps,
    gpu.analysis.ctb_activity, Encoder._derive_qp_map) and keeps every
    call's inputs and outputs on the host, for the CPU comparison."""

    def __enter__(self):
        from svt_hevc_tpu_torch.gpu import analysis as ga
        from svt_hevc_tpu_torch.pipeline import encoder as pe
        self.me, self.ois, self.act, self.qpm = [], [], [], []
        self._saved = (pe.dev_me_field, pe.Encoder._ois_maps,
                       ga.ctb_activity, pe.Encoder._derive_qp_map)
        me_f, ois_f, act_f, qpm_f = self._saved

        def me(src, ref, device):
            out = me_f(src, ref, device)
            self.me.append((src, ref, out))
            return out

        def ois(enc, y):
            out = ois_f(enc, y)
            self.ois.append((y if isinstance(y, np.ndarray)
                             else y.cpu().numpy(), out))
            return out

        def act(y, ctb):
            out = act_f(y, ctb)
            self.act.append((y.cpu().numpy(), ctb, out.cpu().numpy()))
            return out

        def qpm(enc, y, base_qp, frame=None):
            out = qpm_f(enc, y, base_qp, frame=frame)
            self.qpm.append((base_qp, out))
            return out

        pe.dev_me_field, pe.Encoder._ois_maps = me, ois
        ga.ctb_activity, pe.Encoder._derive_qp_map = act, qpm
        return self

    def __exit__(self, *exc):
        from svt_hevc_tpu_torch.gpu import analysis as ga
        from svt_hevc_tpu_torch.pipeline import encoder as pe
        (pe.dev_me_field, pe.Encoder._ois_maps, ga.ctb_activity,
         pe.Encoder._derive_qp_map) = self._saved


def _denoise_digests(frames, maxval: int, device: str) -> list:
    """denoise_plane of every plane of frames on device: (sha256 of the
    float32 output plane, sigma) per plane."""
    import torch
    from svt_hevc_tpu_torch.gpu.analysis import denoise_plane
    out = []
    for f in frames:
        for p in (f.y, f.cb, f.cr):
            t = torch.from_numpy(p.astype(np.int32)).to(device)
            plane, sigma = denoise_plane(t, maxval=maxval)
            out.append((hashlib.sha256(plane.cpu().numpy().tobytes())
                        .hexdigest(), float(sigma)))
    return out


def cpu_host_helpers(job):
    """The CPU side of phase host_1080p, in a worker process: every
    device helper of the card's encode recomputed with the plain
    versions on the CPU from the same inputs (the ME fields and OIS maps
    from the captured planes, the activities and the QP maps from the
    regenerated frames in encode order), and denoise_plane of the clip's
    frames at 8 and 10 bits. Returns (results, seconds)."""
    import torch
    from svt_hevc_tpu_torch import Encoder
    from svt_hevc_tpu_torch.gpu.analysis import ctb_activity
    from svt_hevc_tpu_torch.pipeline.encoder import dev_me_field
    torch.set_num_threads(CPU_THREADS)
    t0 = time.perf_counter()
    enc = Encoder(_cfg(1920, 1080, **HOST_KW), device="cpu")
    res = {"me": [dev_me_field(src, ref, "cpu") for src, ref in job["me"]],
           "ois": [enc._ois_maps(y) for y in job["ois"]],
           "act": [ctb_activity(torch.from_numpy(y), ctb).numpy()
                   for y, ctb in job["act"]]}
    frames = make_frames(HOST_FRAMES, 1920, 1080, seed=7)
    qenc = Encoder(_cfg(1920, 1080, **HOST_KW), device="cpu")
    res["qpm"] = [qenc._derive_qp_map(f.y, qp, frame=f)
                  for f, qp in zip(frames, job["qps"])]
    res["denoise8"] = _denoise_digests(frames, 255, "cpu")
    res["denoise10"] = _denoise_digests(
        make_frames(HOST_FRAMES, 1920, 1080, seed=7, bit_depth=10), 1023,
        "cpu")
    return res, time.perf_counter() - t0


def phase_host_1080p(results: dict):
    """The host path's target configuration on the card (I + 2 P), with
    its stage split, K1 launches per picture and the helpers' device
    times. Returns (the CPU job of the helpers' comparison, what the
    card computed for it)."""
    import torch
    from svt_hevc_tpu_torch import Encoder
    from svt_hevc_tpu_torch.gpu import analysis as ga
    from svt_hevc_tpu_torch.gpu import encode as genc
    from svt_hevc_tpu_torch.gpu import kernels as K
    from svt_hevc_tpu_torch.pipeline.encoder import pad_plane

    t_phase = time.perf_counter()
    n = HOST_FRAMES
    frames = make_frames(n, 1920, 1080, seed=7)
    enc = Encoder(_cfg(1920, 1080, **HOST_KW))
    names = [k.name for k in K.KERNELS]
    split = genc.STAGE_TIMER = _StageSplit()
    torch.cuda.synchronize()
    K.reset_launches()
    rows, aus = [], []
    try:
        with _HostCapture() as cap:
            t_prev = time.perf_counter()
            c_prev = np.array([k.launches for k in K.KERNELS])
            for au in enc.encode_pictures(iter(frames)):
                t_now = time.perf_counter()
                c_now = np.array([k.launches for k in K.KERNELS])
                rows.append((au, t_now - t_prev, c_now - c_prev))
                aus.append(au)
                t_prev, c_prev = t_now, c_now
    finally:
        genc.STAGE_TIMER = None
    check([a.slice_type for a in aus] == [2] + [1] * (n - 1),
          "host_1080p: not one IDR and P pictures")
    k1 = names.index("sad_field")
    for au, _, c in rows[1:]:
        check(c[k1] > 0, f"host_1080p P{au.poc}: K1 launches {list(c)}")
    for k, name in enumerate(names):
        results[name]["launches_host"] = [int(c[k]) for _, _, c in rows]
    check(len(cap.me) == n - 1 and len(cap.ois) == n
          and len(cap.act) == n and len(cap.qpm) == n,
          f"host_1080p: helper calls me {len(cap.me)} ois {len(cap.ois)} "
          f"act {len(cap.act)} qpm {len(cap.qpm)}")
    stream = enc.headers() + b"".join(a.data for a in aus)
    _decodes_to_recon(stream, aus, "host_1080p")
    psnr = _psnr([a.recon for a in aus], frames)
    log("  1080p M7 2x2 tiles + sharp, IPPP on the host path: "
        + ", ".join(f"{'IPB'[2 - a.slice_type]}{a.poc} {dt:.3f} s "
                    f"({len(a.data)} bytes)" for a, dt, _ in rows)
        + f"; PSNR-Y {psnr:.3f} dB, {len(stream)} bytes, decode == recon")
    log("  launches per picture: " + ", ".join(
        f"{name} {[int(c[k]) for _, _, c in rows]}"
        for k, name in enumerate(names)))
    for _, qmap in cap.qpm:
        log(f"  QP map {qmap.shape[0]}x{qmap.shape[1]}: QP {qmap.min()}.."
            f"{qmap.max()}, {len(np.unique(qmap))} values")
    log("  stage split (synchronized s, per picture): " + "; ".join(
        f"{k} {', '.join(f'{t:.3f}' for t in v)}"
        for k, v in split.s.items()))
    results["host_1080p"] = {
        "seconds": [dt for _, dt, _ in rows],
        "stages": {k: v for k, v in split.s.items()}}

    # the helpers' times at 1080p: CUDA events around one call, median of
    # 10 (host enqueue included: each helper is a chain of eager ops)
    dev = torch.device("cuda")
    y = torch.from_numpy(pad_plane(frames[0].y, 1920, 1088)).to(dev)
    y10 = (y << 2) + 1
    yf = y.float()
    times = {
        "ois_packed": call_ms(lambda: ga.ois_packed(y), 10),
        "ctb_activity": call_ms(lambda: ga.ctb_activity(y, 32), 10),
        "denoise_plane 8-bit": call_ms(
            lambda: ga.denoise_plane(yf, 255), 10),
        "denoise_plane 10-bit": call_ms(
            lambda: ga.denoise_plane(y10, 1023), 10)}
    results["host_1080p"]["helper_call_ms"] = times
    log("  helpers at 1920x1088, ms per call (events, median of 10): "
        + ", ".join(f"{k} {v:.3f}" for k, v in times.items()))
    card = {"me": [out for _, _, out in cap.me],
            "ois": [out for _, out in cap.ois],
            "act": [out for _, _, out in cap.act],
            "qpm": [out for _, out in cap.qpm],
            "denoise8": _denoise_digests(frames, 255, "cuda"),
            "denoise10": _denoise_digests(
                make_frames(n, 1920, 1080, seed=7, bit_depth=10), 1023,
                "cuda")}
    job = {"me": [(src, ref) for src, ref, _ in cap.me],
           "ois": [y for y, _ in cap.ois],
           "act": [(y, ctb) for y, ctb, _ in cap.act],
           "qps": [qp for qp, _ in cap.qpm]}
    log(f"phase host_1080p: 1920x1080 x{n} through the host path on the "
        f"card ({time.perf_counter() - t_phase:.3f} s)")
    return job, card


def phase_host_check(card, cpu):
    """phase host_1080p's device helpers: card == CPU."""
    t0 = time.perf_counter()
    got, t_cpu = cpu.result()
    for i, (a, b) in enumerate(zip(card["me"], got["me"])):
        check(np.array_equal(a, b), f"host_1080p ME field {i}: card != CPU")
    for i, (a, b) in enumerate(zip(card["ois"], got["ois"])):
        for n in (4, 8, 16, 32):
            check(all(np.array_equal(x, y) for x, y in zip(a[n], b[n])),
                  f"host_1080p OIS maps {n}x{n} of picture {i}: card != CPU")
    for key in ("act", "qpm"):
        for i, (a, b) in enumerate(zip(card[key], got[key])):
            check(a.dtype == b.dtype and np.array_equal(a, b),
                  f"host_1080p {key} of picture {i}: card != CPU")
    for key in ("denoise8", "denoise10"):
        check(card[key] == got[key], f"host_1080p {key}: card != CPU")
    sig = [s for _, s in card["denoise8"][::3]]
    sig10 = [s for _, s in card["denoise10"][::3]]
    log(f"phase host_check: ME fields x{len(card['me'])}, OIS maps, "
        f"ctb_activity and QP maps x{len(card['qpm'])}, denoise_plane of "
        f"9 planes at 8 and 10 bits (luma sigma {sig} / {sig10}): card == "
        f"CPU (CPU {t_cpu:.3f} s in a worker) "
        f"({time.perf_counter() - t0:.3f} s)")


def phase_small_host(cpus):
    """The host path at small sizes: the JAX package's sha256 for the
    SMALL_HOST clips, card == CPU for those and the HOST_VARIANTS, decode
    == recon."""
    from svt_hevc_tpu_torch import Encoder
    t0 = time.perf_counter()
    parts = []
    for name, (kw, n, fkw, w, h, sha_want, nbytes) in SMALL_HOST.items():
        frames = make_frames(n, w, h, seed=11, **fkw)
        hdr, aus = _encode(frames, w, h, "cuda", **kw)
        s_gpu = hdr + b"".join(a.data for a in aus)
        hdr_c, aus_c, t_cpu, _ = cpus[name].result()
        check(s_gpu == hdr_c + b"".join(aus_c),
              f"{name}: card stream != CPU stream")
        sha = hashlib.sha256(s_gpu).hexdigest()
        check(sha == sha_want and len(s_gpu) == nbytes,
              f"{name}: sha256 {sha} / {len(s_gpu)} bytes != reference")
        _decodes_to_recon(s_gpu, aus, name)
        parts.append(f"{name} {w}x{h} x{n} {len(s_gpu)} bytes (sha256 "
                     f"match)")
    for i, (name, kw, n, fkw, w, h, mode) in enumerate(HOST_VARIANTS):
        frames = make_frames(n, w, h, seed=11, **fkw)
        hdr_c, aus_c, _, extra = cpus[f"host_variant{i}"].result()
        if mode == "speed":
            enc = Encoder(_cfg(w, h, **kw))
            enc.set_speed_control(1e9)
            hdr, aus = enc.headers(), list(enc.encode_pictures(frames))
            check(enc._dyn_enc_mode == extra,
                  f"{name}: dynamic preset {enc._dyn_enc_mode} / CPU "
                  f"{extra}")
        else:
            if mode == "sov":
                frames = _with_segment_ov(frames, w, h)
            hdr, aus = _encode(frames, w, h, "cuda", **kw)
        s_gpu = hdr + b"".join(a.data for a in aus)
        check(s_gpu == hdr_c + b"".join(aus_c),
              f"{name}: card stream != CPU stream")
        _decodes_to_recon(s_gpu, aus, name)
        parts.append(f"{name} {w}x{h} x{n} {len(s_gpu)} bytes")
    log(f"phase small_host: card == CPU, decode == recon: "
        f"{'; '.join(parts)} ({time.perf_counter() - t0:.3f} s)")


def phase_cpu_1080p(main_aus, ra_aus, cli_stream, cpu_main, cpu_ra,
                    cpu_cli):
    """The 1080p access units of phases main, ra and cli_1080p against
    CPU encodes: I + P of the first two frames; the first three access
    units (I0, P4, B2) of the random-access stream, which the generator
    yields without encoding the rest; the first two of the command line's
    10-bit M8 VBR stream (its lookahead batch holds all 5 frames on both
    sides)."""
    t0 = time.perf_counter()
    _, aus_c, t_main, _ = cpu_main.result()
    for i in range(2):
        check(main_aus[i].data == aus_c[i],
              f"1080p AU {i}: card bytes != CPU bytes")
    _, aus_c, t_ra, _ = cpu_ra.result()
    for i in range(3):
        check(ra_aus[i].data == aus_c[i],
              f"1080p RA AU {i} (POC {ra_aus[i].poc}): card bytes != CPU "
              f"bytes")
    hdr_c, aus_c, t_cli, _ = cpu_cli.result()
    check(cli_stream.startswith(hdr_c + aus_c[0] + aus_c[1]),
          "1080p cli I + P access units: card bytes != CPU bytes")
    log(f"phase cpu_1080p: main I + P access units == CPU encode (CPU "
        f"{t_main:.3f} s in a worker), ra I0 + P4 + B2 access units == CPU "
        f"encode (CPU {t_ra:.3f} s in a worker), cli_1080p I + P access "
        f"units == CPU encode (CPU {t_cli:.3f} s in a worker) "
        f"({time.perf_counter() - t0:.3f} s)")


def main() -> int:
    try:
        import torch
    except ImportError:
        log("FAIL: torch is not installed")
        return 1
    if not torch.cuda.is_available():
        log("FAIL: torch.cuda.is_available() is false")
        return 1
    sys.path.insert(0, HERE)
    try:
        import svt_hevc_tpu_torch  # noqa: F401
    except ImportError as e:
        log(f"FAIL: the port package is missing beside this script ({e})")
        return 1
    card = phase_card()
    phase_build()
    results: dict = {}
    phase_kernels(results)
    main_aus = phase_main(results)
    ra_aus = phase_ra(results)
    cli_stream = phase_cli_1080p(results)
    host_job, host_card = phase_host_1080p(results)
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor
    pool = ProcessPoolExecutor(
        max_workers=CPU_WORKERS,
        mp_context=multiprocessing.get_context("spawn"))
    try:
        cpu = {name: pool.submit(cpu_reference, job)
               for name, job in cpu_jobs().items()}
        cpu_host = pool.submit(cpu_host_helpers, host_job)
        del host_job
        phase_small(cpu["small"])
        phase_small_ra(cpu["small_ra"])
        phase_small_new(cpu)
        phase_variants([cpu[f"variant{i}"] for i in range(len(VARIANTS))])
        phase_stream_variants([cpu[f"stream_variant{i}"]
                               for i in range(len(STREAM_VARIANTS))])
        phase_small_host(cpu)
        phase_host_check(host_card, cpu_host)
        phase_cpu_1080p(main_aus, ra_aus, cli_stream, cpu["main"],
                        cpu["ra"], cpu["cli"])
    finally:
        pool.shutdown(wait=True, cancel_futures=True)
    src = {"sad_field": ("svt_hevc_tpu_torch/csrc/sad_field.cu",
                         "svt_hevc_tpu/tpu/pallas_kernels.py:71"),
           "mc_block": ("svt_hevc_tpu_torch/csrc/mc_block.cu",
                        "svt_hevc_tpu/tpu/pallas_kernels.py:182")}
    rows = []
    for name in ("sad_field", "mc_block"):
        r = results[name]
        row = {"name": name, "route": "cuda", "source": src[name][0],
               "replaces": src[name][1], "launches": r["launches"],
               "max_abs_err": r["max_abs_err"], "ms": r["device_ms"],
               "device_ms": r["device_ms"], "call_ms": r["call_ms"],
               "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
               "bound_by": r["bound_by"], "library_ms": None,
               "launches_ra": r["launches_ra"],
               "launches_per_b_picture": r["launches_per_b_picture"],
               "launches_cli": r["launches_cli"],
               "launches_per_p_picture_m8": r["launches_per_p_picture_m8"],
               "launches_per_picture_host": r["launches_host"]}
        keys = ("device_ms", "call_ms", "plain_ms", "bound_ms", "bound_by")
        row["bd10"] = {k: r["bd10"][k] for k in keys}
        if "b_launch" in r:
            row["b_launch"] = {k: r["b_launch"][k] for k in keys}
        rows.append(row)
    log(f"card: {card}")
    log(json.dumps({"kernels": rows}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--cli-probe"]:
        sys.path.insert(0, HERE)
        sys.exit(cli_probe(sys.argv[2], sys.argv[4:]))
    sys.exit(main())
