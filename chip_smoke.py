"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (one line each, with seconds; any failure exits nonzero; a line
of a phase that ran fused P chains in the main process ends with how
many, how many of them were replayed from a recorded script, and the
scripts recorded, and each variant's card worker prints the same). The
timed card phases (kernels, kernels_uhd, main, ra, cli_1080p,
host_1080p, leaves_1080p, bd_1080p, uhd_2160p, uhd_4320p_vbr) run
first, and each holds its whole stream to the JAX package's bytes and
sha256 (JAX_1080P, JAX_UHD); kernels, subpel and main run with nothing
else on the host, and from phase ra on the CPU reference encodes of the
small clips run beside them in worker processes (one thread each), and
so does the 4320p command line of phase uhd_4320p_vbr, in a subprocess
on the card. Then the card encodes the small clips
beside the bench's subprocesses: the main process those of phases
small_leaves, small, small_ra (and the CPU checkpoint's tail of phase
stream_variants), CARD_WORKERS card worker processes those of phases
small_new, variants, stream_variants and small_host, each with its
decode checks, and the main process holds each worker's stream to the
CPU's and the recorded sha256. Every 4:2:0 stream that is decoded below
is also decoded by libde265 (through the port's binding) where the
library is installed, and must give the recon:
  1. card      name / power limit (nvidia-smi), versions, and whether
               libde265 is installed
  2. build     nvcc builds of the CUDA kernels (csrc/), all at once, with
               each kernel's registers, shared memory and spills, and
               the native host emitter (native/*.c, the system compiler)
  3. kernels   every kernel against its plain PyTorch version on the
               card at the 1080p main-path shapes (torch.equal), the
               batched K2 shapes the callers use included (K=13 and the
               B path's K=9 of the CTB-64 merge snaps too), 8-bit and
               10-bit (K1 and K2 timed at both), K3 at the lookahead's
               1080p shape (5202 chains of 135 window sums) and under
               the plans of ten more grids (row lanes, a split column,
               two levels), with two
               times per variant: device_ms, the kernel's time (CUDA
               events around R_LAUNCHES back-to-back launches, over R),
               and call_ms, the host-inclusive time of one wrapper call
               (what a launch-bound caller pays); the plain version's
               device time and the bound beside them
     kernels_uhd
               every kernel against its plain version at 4320p shapes:
               K1 at the three hme_search levels of 7680x4352, K2's K=10
               luma launch on the 4320p plane, K3 under the 4320p
               lookahead's two-level plan (867 sums of 34 x 60 window
               sums); device_ms, call_ms, plain and bound as above
  4. subpel    the dense search's staged quarter-pel helpers (no
               kernel; nothing on the encoder's paths calls them:
               _recenter8, _subpel_raw8, _subpel_pred8, _refine_subpel
               at k = 8, 16, 32) on CUDA tensors == on CPU tensors at
               1088x1920
  5. main      1920x1080 x 5 frames, M7, qp 32, IPPP, on the card: IDR /
               first P / steady P seconds from the benchmark's own timed
               loop (tools/torch_bench.py's timed_encode; steady P over
               access units 3 and 4), K1 / K2 launches per P picture
               (all > 0), recon PSNR, libde265 decode == recon, the
               stream == JAX_1080P["main"]
  6. ra        1920x1080 x 5 frames, M7, qp 32, random access (hl=2: I0
               P4 B2 B1 B3), on the card: IDR, P-anchor and per-layer B
               seconds per picture, K1 / K2 launches per B picture (all >
               0), recon PSNR, the stream == JAX_1080P["ra"]
  7. cli_1080p the command line (svt_hevc_tpu_torch.app's main, in a
               subprocess on the card) on a seeded 1920x1080 10-bit raw
               clip of 5 frames with new textured ramps on the odd
               pictures:
               -bit-depth 10 -encMode 8 -intra-period -1 -rc 1 -tbr
               8000000 -fps 50 (VBR, default lookahead 17): IDR and per-P
               seconds, the P pictures that carry intra CUs, the
               wavefront steps they ran (at least one) and its seconds,
               the host's wait in the any_intra read, QP per picture,
               kbit/s against the target, K1 / K2 launches per P picture
               (all > 0), K3's launches in the lookahead (> 0), PSNR-Y,
               decode == recon, the CLI's file == JAX_1080P["cli_1080p"];
               lookahead_stats card == CPU on the clip's batch (every
               output) and its time at batches of 6 and 37 frames
  8. host_1080p
               the host path's target configuration: 1920x1080 x 3
               frames, M7, qp 32, IPPP, 2x2 tiles, improve_sharpness
               (adaptive QP with the content classes), on the card:
               seconds and bytes per picture, K1 launches per picture
               (the motion seed, > 0 in each P picture), the QP maps, the
               stage split (device seconds from the port's tracer:
               dev_me_field, ois_maps, qp_map,
               pass 1, DLF + SAO, pass 2, CABAC), decode == recon, the
               stream == JAX_1080P["host_1080p"]; the
               device times of ois_packed, ctb_activity and denoise_plane
               (8 and 10 bits) at 1920x1088
  9. small     512x256 x 10 frames, M7, qp 32, IPPP, on the card and on
               the CPU: streams byte-identical, equal to the reference
               sha256, decoded by the port's decoder to the recon
 10. small_ra  512x256 x 9 frames, M7, qp 32, random access (hierarchical
               B, hl=2), on the card and on the CPU: streams
               byte-identical, equal to the reference sha256, decoded by
               the port's decoder to the recon
 11. small_new 512x256 clips of M8-M9, 10-bit and VBR the same way
               (card == CPU == reference sha256, decode == recon): M8
               IPPP x10 and M9 RA hl=2 x9 (new ramps on the odd pictures;
               intra CUs in P and in B pictures asserted), 10-bit M7 IPPP
               x10, VBR with lookahead 8 x10
 12. variants  the other fused-path configurations (presets M6, M10,
               M11; CTB 64; hierarchical low-delay P; low-delay B; random
               access hl=1; open GOP with a CRA and RASL pictures),
               512x256 x 5 frames each (x 9 for the open GOP): card stream
               == CPU stream, decoded to the recon
 13. stream_variants
               further paths, 512x256, card == CPU, decode == recon:
               10-bit RA hl=2, CTB 64 RA hl=2, 10-bit M8 low-delay B, VBR
               with hierarchical low-delay P, a checkpoint split on the
               card == the continuous encode, a CPU-made checkpoint
               restored on the card, EncoderHandle streaming == batch,
               speed control (the dynamic preset rising to M11)
 14. small_host
               the host path at small sizes, card == CPU, decode ==
               recon: 2x2 tiles, 4:2:2, improve_sharpness, constrained
               intra (a fused I and host P pictures), M5 (256x128) and
               denoise (a noisy source, then the fused path) against the
               JAX streams' sha256; MCTS, sharpness with a slice per
               tile, 4:4:4 RA hl=2, sharpness RA hl=2 (host-path B
               pictures), bit-rate reduction at 10 bits, segment
               overrides, M0 (256x128) and speed control rising from M5
               into the fused presets
 15. host_check
               every device helper of phase host_1080p (the two ME
               fields, the three pictures' OIS maps, ctb_activity and QP
               maps) and denoise_plane of the clip's frames at 8 and 10
               bits equal to a CPU computation from the same inputs (in a
               worker, with the plain versions)
 16. leaves_1080p
               the leaf-lane path at full width: 1920x1080 x 5 frames,
               M7, qp 32, hierarchical low-delay P (hl=1: I0, leaves 1
               and 3, layer-0 P 2 and 4), mesh_pictures with
               parallel.pictures.lane_devices set to two lanes on cuda:0:
               seconds and kernel launches of each picture's encode_frame
               and of the lane dispatch apart, launches per leaf (K1 3,
               K2 13), libde265 decode == recon, the stream ==
               JAX_1080P["leaves_1080p"] (the JAX package's stream
               with lanes and without: so also the stream without lanes)
 17. bd_1080p  the BD artifacts' configuration at full width: the clip of
               BD_r05_1080p_ipp.json (tools/torch_compare_reference.py's
               make_clip_scene, 1920x1080 x 24), qp 32 (the artifact's
               middle row), M7, CTB 64, IDR period 31, scene-cut off,
               IPPP, on the card: the stream must have the artifact's
               68573 bytes and the recon its PSNR-Y 39.331 dB (the JAX
               package's, from the CPU); IDR seconds and its wavefront
               steps (64 * 62 = 3968), seconds per P picture, K1 / K2
               launches per P picture (all > 0), the stream ==
               JAX_1080P["bd_1080p"]; phase bd_check (at the
               end): the port's decoder, in a worker, gives back the
               recon, with the same PSNR-Y
 18. small_leaves
               512x256 leaf clips with two lanes on cuda:0, hl=1 x10 and
               hl=2 with intra_period=7 x14: sha256 == the JAX package's
               stream (the same with mesh_pictures and without), decode
               == recon
 19. mesh      parallel.mesh at world size 1 over NCCL on cuda:0 (a file
               init_method under build/): sharded_hme at 1920x1088 (3 K1
               launches); K1 == its plain version on the 1216x1920 slab
               (halo added) at all three levels; sharded_hme == the slab's
               hme_search with the plain version in K1's place, == the
               slab's hme_search with K1, and == the whole picture's on
               the interior block rows;
               gop_encode_step on 2 x 256x256 == fast_p_fused_packed per
               picture == the same steps over gloo on the CPU (a worker);
               frontend_step's total finite and == the CPU's (rtol 1e-9)
 20. bench     tools/torch_bench.py --gpu-cpu-check in a subprocess
               (started with the CPU workers): exit code 0, the card's
               and the CPU's streams of bench.py's check clip identical,
               with the JAX package's 19785 bytes and sha256; and
               tools/torch_bench.py itself in a second subprocess: its
               64-frame 1080p stream == JAX_1080P["bench"], decode ==
               recon (its times, taken beside the small-clip phases, are
               not kept)
     uhd_2160p main's configuration at 3840x2160 x3 (after bd_1080p):
               per access unit seconds, the IDR's wavefront steps (4064),
               K1 / K2 launches per P picture (all > 0), PSNR-Y, peak
               card memory, the stream == JAX_UHD["uhd_2160p"]
     uhd_4320p_vbr
               the command line at 7680x4320 x3, 8-bit M7 VBR at 40
               Mbit/s (UHD_CLI_TOKENS; started after phase main, in a
               subprocess beside the 1080p phases): per access unit
               seconds, the IDR's wavefront steps (8160), K1 / K2 launches
               per P picture, K3's in the lookahead (> 0: the batch's 34 x
               60 grid of window sums takes the two-level plan), QP per
               picture, kbit/s, the subprocess's peak card memory, the
               CLI's file == JAX_UHD["uhd_4320p_vbr"]; lookahead_stats of
               the batch on the card == the port on the CPU (a worker,
               every output), its card time and peak memory
     uhd_check the port's decoder (in CPU workers) gives back both UHD
               streams' recons
The line before the last is the kernel JSON, the last line the device
JSON. Imports nothing of JAX.

    python3 chip_smoke.py --cli-probe OUT.json -- <app tokens>

runs the command line's main with those tokens and writes, per access
unit, its seconds, kernel launches, intra wavefront runs, steps and
seconds and the any_intra wait to OUT.json (what phase cli_1080p starts
in a subprocess).
"""

from __future__ import annotations

import contextlib
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

# phase leaves_1080p: the leaf-lane path at full width, 1920x1080 x5 of
# make_frames(seed=7), M7, qp 32, hierarchical low-delay P with one
# temporal level (I0, leaves 1 and 3, layer-0 P 2 and 4), mesh_pictures
# with two lanes on the one card
LEAVES_FRAMES = 5
LEAVES_KW = dict(hierarchical_levels=1, mesh_pictures=True)

# The JAX reference package's streams of the small leaf clips (512x256,
# qp 32, M7, fps_num=50, make_frames(seed=11)), computed on the CPU with
# its 8 virtual devices by tests/test_torch_parity_1080p.py (script
# mode): the same with mesh_pictures and without it, under three fresh
# compiles (the compile cache off; the default ISA, AVX-512, and XLA
# capped at AVX2 and at SSE4_2): (config, frames, sha256, bytes)
SMALL_LEAVES = {
    "leaves_hl1": (dict(hierarchical_levels=1), 10,
                   "2d8c1817c4bb26e608e3fdcde41abe2a"
                   "9a40d510b29f3026ffa1cb86ce57cd38", 20238),
    "leaves_hl2_idr": (dict(hierarchical_levels=2, intra_period=7), 14,
                       "e4ffb8228eb3633e9a39582e3fad3657"
                       "dbe112b6a3d16a0b3ef55d10e3e5df9b", 34465),
}

# phase bd_1080p: the BD artifacts' configuration (CTB 64, IDR period 31,
# no scene-cut detection, M7) at 1920x1080 on the artifact's own clip
# (tools/torch_compare_reference.make_clip_scene(1920, 1080, 24)) at its
# middle QP: the stream must have the artifact's bytes and PSNR-Y (the
# JAX package's, computed on the CPU)
BD_ARTIFACT = "BD_r05_1080p_ipp.json"
BD_QP = 32
# the fused IDR's intra wavefront at CTB 64: 64 z-slots per CTB along
# 2 * (17 - 1) + 30 CTB diagonals of the 1920x1088 grid
BD_IDR_STEPS = 64 * (2 * 16 + 30)

# phase mesh: gop_encode_step / frontend_step at 256x256 on 2 pictures of
# make_frames(3, 256, 256, seed=13) (picture b+1 against picture b)
MESH_HW = 256
MESH_B = 2

# The JAX package's whole 1080p streams of the card's phases: (bytes,
# sha256) of main (bench.py's configuration, x5), bench (the same at
# tools/torch_bench.py's 64 frames), ra (x5, RA_KW), cli_1080p (the
# command line's file), host_1080p (x3, HOST_KW), leaves_1080p (x5,
# LEAVES_KW; on one device mesh_pictures changes nothing, so it is the hl=1
# stream) and bd_1080p (BD_ARTIFACT's clip and configuration at BD_QP,
# x24); computed on the CPU by tests/test_torch_parity_1080p.py (its
# script mode), each under three fresh compiles of the JAX graphs (the
# compile cache off; the host's default ISA, AVX-512, and XLA's ISA
# capped at AVX2 and at SSE4_2), which gave the same streams
JAX_1080P = {
    "main": (206499, "168aeb85411c998c54587ed0fc9bc194"
              "f9927826c1ee033906b09c079444205e"),
    "bench": (496981, "98ce6e469a20fedd7630b062c88a33eb"
               "b8644f95ef6c4e70189e3d749b598971"),
    "ra": (205830, "e948743fca467a1b4322c5ac451648f3"
            "fdb78921f928b2bb7d46f8e1c3717023"),
    "cli_1080p": (233793, "e488dade920658b8ef675f04a00d87c1"
                   "a7e1ea80c451812fe3255c130e7db2db"),
    "host_1080p": (234903, "f74f3f9a9dd5c963198106f106d66d3f"
                    "b5420ed122856e547596ec08db3b315c"),
    "leaves_1080p": (206464, "2c74ff17fc923aed27b14095da564db7"
                      "78efe1c61804fff0122ad03e69b168f6"),
    "bd_1080p": (68573, "edfbe63d84ca6593fb737d0a72992945"
                  "a7a54b20d6cbabe8a21f8b8eb79a8d42"),
}

# The UHD phases: uhd_2160p is main's configuration (bench_config) at
# 3840x2160 through Encoder.encode_pictures; uhd_4320p_vbr the command
# line (UHD_CLI_TOKENS, 8-bit M7 VBR, the default lookahead) at 7680x4320,
# whose lookahead reduces its 1080x1920 decimated planes in two levels of
# XLA windows; each x UHD_FRAMES of make_frames(seed=7)
UHD_FRAMES = 3
UHD_SIZES = {"uhd_2160p": (3840, 2160), "uhd_4320p_vbr": (7680, 4320)}
UHD_CLI_TOKENS = ["-w", "7680", "-h", "4320", "-bit-depth", "8",
                  "-encMode", "7", "-intra-period", "-1", "-rc", "1",
                  "-tbr", "40000000", "-fps", "30"]


def uhd_config_kw(name: str) -> dict:
    """The EncoderConfig keywords of uhd_2160p (main's at 3840x2160)."""
    w, h = UHD_SIZES[name]
    return dict(width=w, height=h, qp=32, fps_num=50, enc_mode=7,
                intra_period=-1)


# The JAX package's whole UHD streams: (bytes, sha256), computed on the
# CPU by tests/test_torch_parity_uhd.py (its script mode) with the
# compile cache off, under three fresh compiles of the JAX graphs (the
# host's default ISA, AVX-512, and XLA's ISA capped at AVX2 and at
# SSE4_2), which gave the same streams
JAX_UHD = {
    "uhd_2160p": (809050, "224989c245cc4a1aecf5dd92d15b5a59"
                  "50f7b94554ebe3d1726af5429c28f765"),
    "uhd_4320p_vbr": (3231914, "c5d7e87611667103017960851435851c"
                      "8957f1fe2bdc674ac778bdaa24ad8888"),
}

# launches per device-time sample (CUDA events around a run of many
# launches)
R_LAUNCHES = 200

# worker processes (and torch threads in each) for the CPU reference
# encodes of the small clips: most of a CPU encode is the IDR's
# sequential wavefront of small steps, which more threads do not speed up
# (the 1080p streams are held to JAX_1080P instead); five one-thread
# workers beside the host-bound main process leave the 8 cores of the
# card's machine unsubscribed
CPU_WORKERS = 5
CPU_THREADS = 1
# worker processes that encode the small clips of phases small_new,
# variants, stream_variants and small_host on the card while the main
# process encodes the others: each encode is a host-bound chain of small
# launches on one thread with the card mostly idle, so the processes'
# encodes overlap on the one card
CARD_WORKERS = 3
# phase bench's subprocesses (tools/torch_bench.py --gpu-cpu-check, then
# the benchmark itself)
BENCH_CHECK_TIMEOUT_S = 600
BENCH_RUN_TIMEOUT_S = 600

RA_KW = dict(pred_structure=2, hierarchical_levels=2)
# (config, frames) of phase variants, 512x256
VARIANTS = ((dict(enc_mode=6), 5), (dict(enc_mode=10), 5),
            # the BD artifacts' CTB (the 64x64 level, 64 wavefront slots)
            (dict(ctb_size=64), 5),
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
    ("CTB 64 RA hl=2", dict(ctb_size=64, **RA_KW), 5, {}, "plain"),
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


_BENCH_TOOL = None


_PCHAIN_SEEN: dict = {}


def _p_chain_note() -> str:
    """The fused P chains of this process since the last call: run, of
    them replayed from a recorded script, and scripts recorded
    (gpu.encode.PCHAIN; empty before the port is imported)."""
    genc = sys.modules.get("svt_hevc_tpu_torch.gpu.encode")
    if genc is None:
        return ""
    now = dict(genc.PCHAIN)
    d = {k: v - _PCHAIN_SEEN.get(k, 0) for k, v in now.items()}
    _PCHAIN_SEEN.update(now)
    if not d["runs"]:
        return ""
    return (f" [P chains {d['runs']}, replayed {d['graph_runs']}, "
            f"scripts recorded {d['captures']}]")


def log(msg: str) -> None:
    """Print one line; a phase line of this process ends with its fused P
    chains' script counts (_p_chain_note)."""
    if msg.startswith("phase "):
        msg += _p_chain_note()
    print(msg, flush=True)


def _bench_tool():
    """tools/torch_bench.py (bench.py's twin on the port), loaded by file
    (tools/ is not a package)."""
    global _BENCH_TOOL
    if _BENCH_TOOL is None:
        import importlib.util
        spec = importlib.util.spec_from_file_location(
            "torch_bench", os.path.join(HERE, "tools", "torch_bench.py"))
        _BENCH_TOOL = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(_BENCH_TOOL)
    return _BENCH_TOOL


def make_frames(n, w, h, seed=7, patches=False, bit_depth=8,
                chroma_format=1, noise=0.0):
    """Synthetic content: the benchmark's frames (tools/torch_bench.py's
    make_frames, bench.py's generator: textured luma and chroma with a
    global pan and a moving object), then per picture: patches: every
    odd picture gets (w // 256) * (h // 256) new 64x64 smooth ramps of
    seeded slope, direction and place, which no reference holds (intra
    CUs at M8-M9; the even pictures show what a picture without them
    costs). bit_depth 10: the samples times 4 plus seeded 2-bit noise, as
    uint16. noise: seeded Gaussian noise of that standard deviation on
    the 8-bit luma (a source the denoiser filters). chroma_format 2 / 3:
    the 4:2:0 chroma rows (and columns) repeated to 4:2:2 / 4:4:4."""
    from svt_hevc_tpu_torch.io.yuv import Frame
    frames = []
    for i, base in enumerate(_bench_tool().make_frames(n, w, h, seed)):
        y, cb, cr = base.y, base.cb, base.cr
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


def check_jax_stream(name: str, stream: bytes) -> str:
    """Fail unless stream is the JAX package's whole stream of phase
    name (JAX_1080P, JAX_UHD); returns the log's words for it."""
    n, sha = {**JAX_1080P, **JAX_UHD}[name]
    got = hashlib.sha256(stream).hexdigest()
    check(len(stream) == n and got == sha,
          f"{name}: {len(stream)} bytes, sha256 {got}; the JAX package's "
          f"stream is {n} bytes, sha256 {sha}")
    return f"== the JAX package's stream ({n} bytes, sha256 {sha[:12]}...)"


def _picture_kernels(K):
    """The kernels every fused P / B picture launches (K1, K2); K3 runs in
    the lookahead only."""
    return (K.SAD_FIELD, K.MC_BLOCK)


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
    log(f"  libde265: {'present' if _libde265() else 'absent'} on this "
        f"machine (where present, every 4:2:0 stream below is also "
        f"decoded by it)")
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
    # ---- K2 as the CTB-64 path launches it: merge_snap's rounded luma
    # launch with the 64 level (the decided field and the A1 / B1 / TMVP
    # fields of four CU sizes, K=13) and merge_snap_b's 14-bit one (K=9)
    mv13 = torch.from_numpy(k2_fields(13, nby, nbx, seed=7)).to(dev)
    mv13c = mv13.clamp(-lim, lim)
    args = k2_args(genc, "luma", exts[8][0], mv13c, True, 8)
    out = genc._mc_luma(exts[8][0], mv13, 8, True)
    want = K.mc_block_ref(*args)
    args9 = k2_args(genc, "luma", exts[8][0], mv13c[:9].contiguous(), False,
                    8)
    out9 = genc._mc_luma(exts[8][0], mv13[:9].contiguous(), 8, False)
    want9 = K.mc_block_ref(*args9)
    torch.cuda.synchronize()
    check(torch.equal(out, want), "K2 CTB-64 luma K=13 differs")
    check(torch.equal(out9, want9), "K2 CTB-64 B-shaped luma K=9 differs")
    max_err["mc_block"] = max(max_err["mc_block"],
                              float((out - want).abs().max()),
                              float((out9 - want9).abs().max()))
    nbytes, ops = k2_work(exts[8][0], args[1:5], *args[5:7])
    k2_64 = time_kernel(lambda a=args: K.mc_block(*a),
                        lambda a=args: K.mc_block_ref(*a), nbytes, ops,
                        plain_reps=2)
    log(f"  K2 mc_block CTB-64 luma bd=8 rounded K=13 (merge_snap) -> "
        f"{'x'.join(map(str, out.shape))}: equal, {_fmt(k2_64)}; 14-bit "
        f"K=9 (merge_snap_b): equal")
    # ---- K3 at the lookahead's 1080p shape: the 9 x 15 window sums of
    # the 289 displacements of a batch of 18 pictures (lookahead 8), each
    # a float32 sum of whole sixteenths below 2^20, whose chain passes
    # 2^24 and rounds
    from svt_hevc_tpu_torch.gpu.analysis import xla_reduce_plan
    q = xla_reduce_plan(9, 15)
    rng = np.random.default_rng(8)
    parts = torch.from_numpy((rng.integers(0, 1 << 24, (289 * 18, 135))
                              / 16.0).astype(np.float32)).to(dev)
    out = K.ordered_sum(parts, q)
    want = K.ordered_sum_ref(parts, q)
    torch.cuda.synchronize()
    check(torch.equal(out, want), "K3 ordered_sum differs from plain")
    k3 = time_kernel(lambda: K.ordered_sum(parts, q),
                     lambda: K.ordered_sum_ref(parts, q),
                     4 * (parts.numel() + out.numel()), parts.numel())
    err = float((out - want).abs().max())
    log(f"  K3 ordered_sum {parts.shape[0]} chains of {parts.shape[1]}: "
        f"equal, {_fmt(k3)}")
    # K3 under every kind of plan xla_reduce_plan gives (2, 4 and 8 row
    # lanes with and without remaining rows, a split last column, one
    # and two levels of windows), each against its plain version
    for grid in ((2, 5), (4, 6), (8, 8), (17, 2), (21, 4), (31, 7),
                 (9, 33), (33, 9), (1, 64), (17, 63)):
        qg = xla_reduce_plan(*grid)
        x = torch.from_numpy((rng.integers(0, 1 << 24, (
            289 * 2, grid[0] * grid[1])) / 16.0).astype(np.float32)).to(dev)
        out, want = K.ordered_sum(x, qg), K.ordered_sum_ref(x, qg)
        torch.cuda.synchronize()
        check(torch.equal(out, want), f"K3 under plan {tuple(qg)} differs "
              f"from plain")
        err = max(err, float((out - want).abs().max()))
    results["ordered_sum"] = dict(k3, max_abs_err=err)
    log("  K3 ordered_sum under the plans of ten grids (row lanes, a split "
        "column, two levels): equal")
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
                               b_launch=k2b, bd10=k2_10,
                               ctb64_launch=k2_64)
    log(f"phase kernels: K1 x3 levels at 8 and 10 bits, K2 x8 one-field, "
        f"x8 batched, the B-shaped and the CTB-64 variants, K3 at the "
        f"lookahead's 1080p shape equal to plain; "
        f"device_ms "
        f"over "
        f"{R_LAUNCHES} launches "
        f"({time.perf_counter() - t0:.3f} s)")


def phase_subpel():
    """The dense search's staged quarter-pel helpers (gpu.encode
    _recenter8, _subpel_raw8, _subpel_pred8, _refine_subpel at k = 8, 16
    and 32; no kernel, and nothing on the encoder's paths calls them) on
    CUDA tensors == the same calls on CPU tensors, at 1080p shapes: the
    padded 1088x1920 luma of make_frames(seed=7), its 16 phase planes,
    seeded quarter-pel fields over [-4 PAD, 4 PAD] per 8x8 block."""
    import torch
    from svt_hevc_tpu_torch.gpu import encode as genc

    t0 = time.perf_counter()
    pad = genc.PAD
    (y0, _, _), (y1, _, _) = _kernel_inputs(torch.device("cpu"))
    src, ref = y1.to(torch.int32), y0.to(torch.int32)
    h, w = src.shape
    raw = genc.luma_phase_planes(ref)
    raw16 = raw.reshape(16, raw.shape[2], raw.shape[3])
    ext = genc._edge_pad(ref, pad)
    rng = np.random.default_rng(17)

    def field(k, lo, hi):
        return torch.from_numpy(rng.integers(lo, hi + 1, (h // k, w // k))
                                .astype(np.int32))

    calls = [("_recenter8", genc._recenter8,
              (ext, field(8, -pad, pad), field(8, -pad, pad), h, w)),
             ("_subpel_raw8", genc._subpel_raw8,
              (raw16, field(8, -4 * pad, 4 * pad),
               field(8, -4 * pad, 4 * pad), h, w)),
             ("_subpel_pred8", genc._subpel_pred8,
              (raw16, field(8, -4 * pad, 4 * pad),
               field(8, -4 * pad, 4 * pad), h, w, 8))]
    for k in (8, 16, 32):
        mvx = field(k, -pad + 8, pad - 8) * 4
        mvy = field(k, -pad + 8, pad - 8) * 4
        pred = genc._subpel_pred8(raw16, genc._rep(mvx, k // 8),
                                  genc._rep(mvy, k // 8), h, w, 8)
        best = genc._boxsum((src - pred).abs(), k)
        calls.append((f"_refine_subpel k={k}", genc._refine_subpel,
                      (src, raw16, mvx, mvy, best, k, 8)))
    parts = []
    for name, fn, args in calls:
        want = fn(*args)
        got = fn(*[a.cuda() if isinstance(a, torch.Tensor) else a
                   for a in args])
        want = want if isinstance(want, tuple) else (want,)
        got = got if isinstance(got, tuple) else (got,)
        check(all(g.is_cuda and torch.equal(g.cpu(), x)
                  for g, x in zip(got, want)),
              f"subpel: {name} on the card != on the CPU")
        if name.startswith("_refine"):
            moved = int(((got[0] != args[2].cuda())
                         | (got[1] != args[3].cuda())).sum())
            name += f" ({moved} of {args[2].numel()} blocks moved)"
        parts.append(name)
    log(f"phase subpel: card == CPU at {h}x{w}: {', '.join(parts)} "
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
    pickled checkpoint after them; sov: segment overrides). Returns
    (headers, access-unit bytes, seconds, extra)."""
    import pickle

    import torch
    from svt_hevc_tpu_torch import Encoder, EncoderConfig
    torch.set_num_threads(CPU_THREADS)
    n, w, h, seed, fkw = job["frames"]
    t0 = time.perf_counter()
    frames = make_frames(n, w, h, seed=seed, **fkw)
    mode = job.get("mode", "plain")
    extra = None
    if mode == "speed":
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


def _card_worker_init() -> None:
    import torch
    torch.set_num_threads(CPU_THREADS)
    torch.zeros(1, device="cuda")


def card_jobs(pool) -> dict:
    """Every small clip a card worker encodes, submitted in the order the
    phases read them: {phase: {key: future}}."""
    return {
        "small_new": {name: pool.submit(card_small_new, name)
                      for name in SMALL_NEW},
        "variants": [pool.submit(card_variant, i)
                     for i in range(len(VARIANTS))],
        "stream_variants": {
            i: pool.submit(card_stream_variant, i)
            for i, v in enumerate(STREAM_VARIANTS) if v[4] != "ckpt_cpu"},
        "small_host": {name: pool.submit(card_small_host, name)
                       for name in [*SMALL_HOST,
                                    *(v[0] for v in HOST_VARIANTS)]}}


def cpu_jobs() -> dict:
    """Every check's CPU reference, longest first (the order the workers
    take them in)."""
    def job(n, w, h, seed, kw, n_aus=None, fkw=None, mode="plain"):
        return {"frames": (n, w, h, seed, fkw or {}), "kw": kw,
                "n_aus": n_aus, "mode": mode}

    jobs = {"small": job(10, 512, 256, 11, {}),
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


def _libde265():
    """The port's libde265 binding where the library is installed, else
    None."""
    from svt_hevc_tpu_torch.io import de265_decoder
    return de265_decoder if de265_decoder.available() else None


def _de265_to_recon(stream: bytes, aus, what: str) -> bool:
    """libde265 (an independent decoder) gives back every picture's recon;
    False where the library is absent or the stream is not 4:2:0 (the
    binding decodes Main and Main10 4:2:0)."""
    lib = _libde265()
    r = aus[0].recon
    if lib is None or r.cb.shape != (r.y.shape[0] // 2, r.y.shape[1] // 2):
        return False
    dec = lib.decode_annexb(stream)
    check(len(dec) == len(aus), f"{what}: libde265 decoded {len(dec)} "
          f"pictures, not {len(aus)}")
    for (y, cb, cr), a in zip(dec, sorted(aus, key=lambda a: a.display_idx)):
        check(np.array_equal(y, np.asarray(a.recon.y, np.int32))
              and np.array_equal(cb, np.asarray(a.recon.cb, np.int32))
              and np.array_equal(cr, np.asarray(a.recon.cr, np.int32)),
              f"{what}: libde265 decode != recon")
    return True


def _decodes_to_recon(stream: bytes, aus, what: str) -> None:
    """The port's decoder, and libde265 where present, give back every
    picture's recon (the decoders output in display order)."""
    from svt_hevc_tpu_torch.decoder.decoder import decode_stream
    dec = decode_stream(stream)
    check(len(dec) == len(aus), f"{what}: decoded picture count")
    for d, a in zip(dec, sorted(aus, key=lambda a: a.display_idx)):
        check(np.array_equal(d.y, a.recon.y)
              and np.array_equal(d.cb, a.recon.cb)
              and np.array_equal(d.cr, a.recon.cr),
              f"{what}: decoded != recon")
    _de265_to_recon(stream, aus, what)


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


def _variant_name(kw) -> str:
    return ",".join(f"{k}={v}" for k, v in kw.items())


def card_variant(i: int) -> bytes:
    """Phase variants' card encode of VARIANTS[i] (in a card worker):
    decode == recon; returns the stream."""
    kw, n = VARIANTS[i]
    _p_chain_note()
    hdr, aus = _encode(make_frames(n, 512, 256, seed=11), 512, 256, "cuda",
                       **kw)
    log(f"variant {_variant_name(kw)} (card worker):"
        f"{_p_chain_note() or ' no P chain'}")
    s_gpu = hdr + b"".join(a.data for a in aus)
    _decodes_to_recon(s_gpu, aus, f"variant {_variant_name(kw)}")
    return s_gpu


def phase_variants(cards, cpus):
    t0 = time.perf_counter()
    parts = []
    for (kw, n), card, cpu in zip(VARIANTS, cards, cpus):
        name = _variant_name(kw)
        s_gpu = card.result()
        hdr_c, aus_c, _, _ = cpu.result()
        check(s_gpu == hdr_c + b"".join(aus_c),
              f"variant {name}: card stream != CPU stream")
        parts.append(f"{name} x{n} {len(s_gpu)} bytes")
    log(f"phase variants: 512x256, card == CPU, decode == recon: "
        f"{'; '.join(parts)} ({time.perf_counter() - t0:.3f} s)")


def phase_main(results: dict):
    """bench.py's configuration for 5 frames, timed by the benchmark's own
    loop (tools/torch_bench.timed_encode: host clock between yielded
    access units; IDR holds the first P picture's dispatch, the steady
    clock starts at access unit 2)."""
    from svt_hevc_tpu_torch import Encoder
    from svt_hevc_tpu_torch.gpu import kernels as K

    tool = _bench_tool()
    t_phase = time.perf_counter()
    n = 5
    frames = make_frames(n, 1920, 1080, seed=7)
    enc = Encoder(tool.bench_config())
    names = [k.name for k in _picture_kernels(K)]

    def counts():
        return np.array([k.launches for k in _picture_kernels(K)])

    K.reset_launches()
    c_start = counts()
    snaps = []
    state = tool.new_state()
    aus = tool.timed_encode(enc, frames, state, "cuda",
                            on_au=lambda au: snaps.append(counts()))
    check(len(aus) == n, f"main: {len(aus)} access units, not {n}")
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
    idr = state["idr_seconds"]
    first_p = state["compile_seconds"]
    steady = state["steady_seconds"] / state["steady_frames"]
    psnr = _psnr([a.recon for a in aus], frames)
    stream = enc.headers() + b"".join(a.data for a in aus)
    same = check_jax_stream("main", stream)
    de265 = _de265_to_recon(stream, aus, "main")
    log(f"  1080p: IDR {idr:.3f} s, first P {first_p:.3f} s, steady P "
        f"{steady:.3f} s/frame over {state['steady_frames']} pictures "
        f"({1.0 / steady:.3f} fps), PSNR-Y "
        f"{psnr:.3f} dB, {sum(len(a.data) for a in aus)} bytes, native "
        f"host emitter, "
        f"{'libde265 decode == recon' if de265 else 'libde265 absent'}")
    log("  access unit seconds: " + " ".join(
        f"{t:.3f}" for t in state["au_seconds"]))
    log("  launches per P picture: " + ", ".join(
        f"{name} {[int(c[k]) for c in per_p]}"
        for k, name in enumerate(names)))
    log(f"  stream {same}")
    log(f"phase main: 1920x1080 x{n} IPPP on the card "
        f"({time.perf_counter() - t_phase:.3f} s)")
    return aus


def bench_check_start():
    """Start tools/torch_bench.py --gpu-cpu-check (its CPU encode at two
    torch threads) and the benchmark itself (its 64-frame 1080p stream
    on the card) in two subprocesses, beside the CPU reference workers."""
    env = dict(os.environ, OMP_NUM_THREADS=str(CPU_THREADS))
    tool = os.path.join(HERE, "tools", "torch_bench.py")
    return time.perf_counter(), [
        subprocess.Popen([sys.executable, tool, *args], cwd=HERE,
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                         text=True, env=env)
        for args in (["--gpu-cpu-check"], [])]


def _last_json(proc, timeout: float, what: str) -> dict:
    out, err = proc.communicate(timeout=timeout)
    check(proc.returncode == 0, f"{what}: exit code {proc.returncode}\n"
          f"{out[-4000:]}\n{err[-4000:]}")
    return json.loads(out.strip().splitlines()[-1])


def phase_bench(started):
    """The benchmark's card == CPU check (bench.py's --tpu-cpu-check clip:
    512x256 x10, make_frames(seed=11), M7, qp 32, IPPP): exit code 0,
    identical streams, and the JAX package's bytes and sha256 for that
    clip (phase small's clip; its 50 fps do not change the stream). Then
    the benchmark's own run: its whole 64-frame 1080p stream is the JAX
    package's (JAX_1080P["bench"]) and decodes to its recon. Its times
    were taken beside the small-clip phases and are not kept."""
    t_start, (proc, run) = started
    t0 = time.perf_counter()
    res = _last_json(proc, BENCH_CHECK_TIMEOUT_S, "bench --gpu-cpu-check")
    check(res["identical"] is True, f"bench --gpu-cpu-check: {res}")
    check(res["bytes_device"] == SMALL_BYTES
          and res["sha256"] == SMALL_SHA256,
          f"bench --gpu-cpu-check: {res['bytes_device']} bytes, sha256 "
          f"{res['sha256']} != the JAX package's {SMALL_BYTES} / "
          f"{SMALL_SHA256}")
    log(f"  {json.dumps(res)}")
    line = _last_json(run, BENCH_RUN_TIMEOUT_S, "tools/torch_bench.py")
    check(line["phase"] == "done" and line["decode_ok"] is True,
          f"tools/torch_bench.py: {line}")
    n, sha = JAX_1080P["bench"]
    check((line["bytes"], line["sha256"]) == (n, sha),
          f"tools/torch_bench.py: {line['bytes']} bytes, sha256 "
          f"{line['sha256']} ({line['steady_frames']} steady pictures); "
          f"the JAX package's 64-frame stream is {n} bytes, sha256 {sha}")
    log(f"  tools/torch_bench.py: {line['bytes']} bytes, sha256 "
        f"{line['sha256'][:12]}..., decode_ok {line['decode_ok']} "
        f"({line['decoder']}), {line['steady_frames']} steady pictures")
    log(f"phase bench: tools/torch_bench.py --gpu-cpu-check, card == CPU, "
        f"{res['bytes_device']} bytes, sha256 match; the benchmark's "
        f"1080p x64 stream == the JAX package's (started "
        f"{t0 - t_start:.3f} s before this phase, waited "
        f"{time.perf_counter() - t0:.3f} s)")


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
    names = [k.name for k in _picture_kernels(K)]

    def counts():
        return np.array([k.launches for k in _picture_kernels(K)])

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
    same = check_jax_stream(
        "ra", enc.headers() + b"".join(a.data for a in aus))
    log(f"  stream {same}")
    log(f"phase ra: 1920x1080 x{n} RA on the card "
        f"({time.perf_counter() - t_phase:.3f} s)")
    return aus



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
    and the intra wavefront runs and steps in between, and from the
    port's tracer the picture's host seconds in the intra fixup's
    any_intra read (the wait for its queued device work) and the device
    seconds of its intra wavefront (between the stage's two CUDA events);
    and the card's peak allocated bytes. VBR pictures are not pipelined,
    so each span is that picture's. Counts start at 0 when the encode
    starts."""
    import torch
    from svt_hevc_tpu_torch import app, trace
    from svt_hevc_tpu_torch.gpu import intra_pass
    from svt_hevc_tpu_torch.gpu import kernels as K
    from svt_hevc_tpu_torch.pipeline.encoder import Encoder

    rows = []
    encode_pictures = Encoder.encode_pictures

    def probed(self, frames, **kw):
        torch.cuda.synchronize()
        K.reset_launches()
        intra_pass.WAVEFRONT.update(runs=0, steps=0)
        tr = trace.Tracer("cuda").start()
        try:
            t_prev, c_prev = time.perf_counter(), _counts()
            for au in encode_pictures(self, frames, **kw):
                t_now, c_now = time.perf_counter(), _counts()
                rows.append({"poc": au.poc, "slice_type": au.slice_type,
                             "idx": au.display_idx,
                             "seconds": t_now - t_prev,
                             "counts": [b - a for a, b in zip(c_prev, c_now)]})
                t_prev, c_prev = t_now, c_now
                yield au
        finally:
            spans = tr.stop()["spans"]
        for row in rows:
            mine = [sp for sp in spans if sp["pic"] == row["idx"]]
            row["any_intra_wait"] = sum(
                (sp["host_ns"][1] - sp["host_ns"][0]) / 1e9 for sp in mine
                if sp["name"].endswith(".any_intra"))
            row["wavefront_s"] = sum(
                (sp["device_ns"][1] - sp["device_ns"][0]) / 1e9
                for sp in mine
                if sp["name"].endswith(".intra_wavefront_pass"))

    Encoder.encode_pictures = probed
    torch.cuda.reset_peak_memory_stats()
    rc = app.main(list(tokens))
    with open(out_path, "w") as f:
        json.dump({"rows": rows,
                   "max_memory_allocated": torch.cuda.max_memory_allocated()},
                  f)
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
        rows = json.load(f)["rows"]
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
    npk = len(_picture_kernels(K))
    p_rows = [row for row in rows if row["slice_type"] == 1]
    check(len(p_rows) == n - 1 and rows[0]["slice_type"] == 2,
          f"cli_1080p: not one IDR and {n - 1} P pictures")
    for row in p_rows:
        check(all(c > 0 for c in row["counts"][:npk]),
              f"cli_1080p P{row['poc']}: launches {row['counts'][:nk]}")
    intra_p = [(row["poc"], row["counts"][nk + 1]) for row in p_rows
               if row["counts"][nk] > 0]
    check(len(intra_p) >= 1, "cli_1080p: no P picture with intra CUs")
    for k, name in enumerate(names):
        results[name]["launches_cli"] = sum(row["counts"][k]
                                            for row in rows)
        results[name]["launches_per_p_picture_m8"] = [
            row["counts"][k] for row in p_rows]
    # K3's path: the lookahead of this VBR stream (counts from 0 at the
    # encode's start in the subprocess)
    k3 = results["ordered_sum"]
    k3["launches"] = k3["launches_cli"]
    check(k3["launches"] > 0, "cli_1080p: K3 ordered_sum never launched")
    same = check_jax_stream("cli_1080p", stream)
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
        for k, name in enumerate(names))
        + f"; K3 {k3['launches']} in the lookahead (with the IDR)")
    log(f"  stream {same}")
    # the lookahead's statistics: card == CPU on this clip's batch, and
    # the card's time at 6 and 37 frames (the clip's batch, and a batch
    # of lookahead 17)
    ys = torch.from_numpy(np.stack([frames[0].y] + [f.y for f in frames])
                          .astype(np.int32))
    got = lookahead_stats(ys.cuda())
    want = lookahead_stats(ys)
    for key in ("zz_sad", "gm_sad", "gm_mv", "hist", "variance"):
        check(torch.equal(got[key].cpu(), want[key]),
              f"lookahead_stats {key}: card != CPU")
    big = ys.cuda().repeat(7, 1, 1)[:37]
    t_b, t37 = _time_lookahead(ys.cuda()), _time_lookahead(big)
    results["lookahead_stats"] = {f"s_{ys.shape[0]}": t_b, "s_37": t37}
    log(f"  lookahead_stats card == CPU (every output); card "
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


def card_small_new(name: str):
    """Phase small_new's card encode of SMALL_NEW[name] (in a card
    worker): decode == recon; returns the stream, the intra wavefront
    runs, the intra pictures and the PSNR-Y."""
    kw, n, fkw, _, _ = SMALL_NEW[name]
    frames = make_frames(n, 512, 256, seed=11, **fkw)
    hdr, aus, runs = _encode_counting_wavefront(name, frames, kw)
    s_gpu = hdr + b"".join(a.data for a in aus)
    _decodes_to_recon(s_gpu, aus, name)
    recons = [a.recon for a in sorted(aus, key=lambda a: a.display_idx)]
    psnr = _psnr(recons, frames,
                 peak=1023.0 if kw.get("bit_depth") == 10 else 255.0)
    return s_gpu, runs, sum(a.slice_type == 2 for a in aus), psnr


def phase_small_new(cards, cpus):
    t0 = time.perf_counter()
    parts = []
    for name, (kw, n, fkw, sha_want, nbytes) in SMALL_NEW.items():
        s_gpu, runs, n_intra, psnr = cards[name].result()
        hdr_c, aus_c, t_cpu, _ = cpus[name].result()
        check(s_gpu == hdr_c + b"".join(aus_c),
              f"{name}: card stream != CPU stream")
        sha = hashlib.sha256(s_gpu).hexdigest()
        check(sha == sha_want and len(s_gpu) == nbytes,
              f"{name}: sha256 {sha} / {len(s_gpu)} bytes != reference")
        if name in ("small_m8", "small_m9_ra"):
            check(runs > n_intra,
                  f"{name}: no inter picture ran the intra wavefront")
        parts.append(f"{name} x{n} {len(s_gpu)} bytes, {runs - n_intra} "
                     f"inter pictures with intra CUs, PSNR-Y {psnr:.3f} "
                     f"dB, CPU {t_cpu:.1f} s")
    log(f"phase small_new: 512x256, sha256 match, card == CPU, decode == "
        f"recon: {'; '.join(parts)} ({time.perf_counter() - t0:.3f} s)")


def card_stream_variant(i: int, extra=None):
    """Phase stream_variants' card encode of STREAM_VARIANTS[i] (in a
    card worker; a ckpt_cpu variant in the main process, with its CPU
    job's extra): the decoders' checks; returns the stream and, for
    speed control, the dynamic preset it reached."""
    import pickle

    from svt_hevc_tpu_torch import Encoder, EncoderHandle
    from svt_hevc_tpu_torch.decoder.decoder import decode_stream
    name, kw, n, fkw, mode = STREAM_VARIANTS[i]
    frames = make_frames(n, 512, 256, seed=11, **fkw)
    cfg = _cfg(512, 256, **kw)
    aus = dyn = None
    if mode == "plain":
        hdr, aus = _encode(frames, 512, 256, "cuda", **kw)
        s_gpu = hdr + b"".join(a.data for a in aus)
    elif mode == "split":
        e1 = Encoder(cfg)
        head = [a.data for a in e1.encode_pictures(frames[:3])]
        e2 = Encoder(cfg)
        e2.restore(pickle.loads(pickle.dumps(e1.checkpoint())))
        tail = [a.data for a in e2.encode_pictures(frames[3:])]
        s_gpu = e2.headers() + b"".join(head + tail)
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
        dyn = enc._dyn_enc_mode
    check(len(decode_stream(s_gpu)) == n,
          f"variant {name}: decoded picture count")
    if aus is not None:
        _decodes_to_recon(s_gpu, aus, f"variant {name}")
    return s_gpu, dyn


def phase_stream_variants(cards, cpus):
    t0 = time.perf_counter()
    parts = []
    for i, ((name, _, n, _, mode), cpu) in enumerate(
            zip(STREAM_VARIANTS, cpus)):
        hdr_c, aus_c, _, extra = cpu.result()
        if mode == "ckpt_cpu":
            s_gpu, dyn = card_stream_variant(i, extra)
        else:
            s_gpu, dyn = cards[i].result()
        if mode == "speed":
            check(dyn == extra == 11, f"variant {name}: dynamic preset "
                  f"{dyn} / CPU {extra}, not 11")
        check(s_gpu == hdr_c + b"".join(aus_c),
              f"variant {name}: card stream != CPU stream")
        parts.append(f"{name} x{n} {len(s_gpu)} bytes")
    log(f"phase stream_variants: 512x256, card == CPU, decodes: "
        f"{'; '.join(parts)} ({time.perf_counter() - t0:.3f} s)")


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
    from svt_hevc_tpu_torch import Encoder, trace
    from svt_hevc_tpu_torch.gpu import analysis as ga
    from svt_hevc_tpu_torch.gpu import kernels as K
    from svt_hevc_tpu_torch.pipeline.encoder import pad_plane

    t_phase = time.perf_counter()
    n = HOST_FRAMES
    frames = make_frames(n, 1920, 1080, seed=7)
    enc = Encoder(_cfg(1920, 1080, **HOST_KW))
    names = [k.name for k in _picture_kernels(K)]
    torch.cuda.synchronize()
    K.reset_launches()
    rows, aus = [], []
    tr = trace.Tracer("cuda").start()
    try:
        with _HostCapture() as cap:
            t_prev = time.perf_counter()
            c_prev = np.array([k.launches for k in _picture_kernels(K)])
            for au in enc.encode_pictures(iter(frames)):
                t_now = time.perf_counter()
                c_now = np.array([k.launches for k in _picture_kernels(K)])
                rows.append((au, t_now - t_prev, c_now - c_prev))
                aus.append(au)
                t_prev, c_prev = t_now, c_now
    finally:
        spans = tr.stop()["spans"]
    # every named stage's device seconds (between its two CUDA events)
    split: dict = {}
    for sp in spans:
        if sp["name"].split(".")[0] in ("i", "p"):
            a, b = sp["device_ns"]
            split.setdefault(sp["name"], []).append((b - a) / 1e9)
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
    same = check_jax_stream("host_1080p", stream)
    _decodes_to_recon(stream, aus, "host_1080p")
    psnr = _psnr([a.recon for a in aus], frames)
    log("  1080p M7 2x2 tiles + sharp, IPPP on the host path: "
        + ", ".join(f"{'IPB'[2 - a.slice_type]}{a.poc} {dt:.3f} s "
                    f"({len(a.data)} bytes)" for a, dt, _ in rows)
        + f"; PSNR-Y {psnr:.3f} dB, {len(stream)} bytes, decode == recon, "
        f"stream {same}")
    log("  launches per picture: " + ", ".join(
        f"{name} {[int(c[k]) for _, _, c in rows]}"
        for k, name in enumerate(names)))
    for _, qmap in cap.qpm:
        log(f"  QP map {qmap.shape[0]}x{qmap.shape[1]}: QP {qmap.min()}.."
            f"{qmap.max()}, {len(np.unique(qmap))} values")
    log("  stage split (device s, per picture): " + "; ".join(
        f"{k} {', '.join(f'{t:.3f}' for t in v)}"
        for k, v in split.items()))
    results["host_1080p"] = {
        "seconds": [dt for _, dt, _ in rows], "stages": split}

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


def card_small_host(name: str):
    """Phase small_host's card encode of SMALL_HOST[name] or of the
    HOST_VARIANTS entry of that name (in a card worker): decode ==
    recon; returns the stream and, for speed control, the dynamic preset
    it reached."""
    from svt_hevc_tpu_torch import Encoder
    if name in SMALL_HOST:
        kw, n, fkw, w, h, _, _ = SMALL_HOST[name]
        mode = "plain"
    else:
        _, kw, n, fkw, w, h, mode = next(v for v in HOST_VARIANTS
                                         if v[0] == name)
    frames = make_frames(n, w, h, seed=11, **fkw)
    dyn = None
    if mode == "speed":
        enc = Encoder(_cfg(w, h, **kw))
        enc.set_speed_control(1e9)
        hdr, aus = enc.headers(), list(enc.encode_pictures(frames))
        dyn = enc._dyn_enc_mode
    else:
        if mode == "sov":
            frames = _with_segment_ov(frames, w, h)
        hdr, aus = _encode(frames, w, h, "cuda", **kw)
    s_gpu = hdr + b"".join(a.data for a in aus)
    _decodes_to_recon(s_gpu, aus, name)
    return s_gpu, dyn


def phase_small_host(cards, cpus):
    """The host path at small sizes: the JAX package's sha256 for the
    SMALL_HOST clips, card == CPU for those and the HOST_VARIANTS, decode
    == recon."""
    t0 = time.perf_counter()
    parts = []
    for name, (kw, n, fkw, w, h, sha_want, nbytes) in SMALL_HOST.items():
        s_gpu, _ = cards[name].result()
        hdr_c, aus_c, t_cpu, _ = cpus[name].result()
        check(s_gpu == hdr_c + b"".join(aus_c),
              f"{name}: card stream != CPU stream")
        sha = hashlib.sha256(s_gpu).hexdigest()
        check(sha == sha_want and len(s_gpu) == nbytes,
              f"{name}: sha256 {sha} / {len(s_gpu)} bytes != reference")
        parts.append(f"{name} {w}x{h} x{n} {len(s_gpu)} bytes (sha256 "
                     f"match)")
    for i, (name, kw, n, fkw, w, h, mode) in enumerate(HOST_VARIANTS):
        s_gpu, dyn = cards[name].result()
        hdr_c, aus_c, _, extra = cpus[f"host_variant{i}"].result()
        if mode == "speed":
            check(dyn == extra,
                  f"{name}: dynamic preset {dyn} / CPU {extra}")
        check(s_gpu == hdr_c + b"".join(aus_c),
              f"{name}: card stream != CPU stream")
        parts.append(f"{name} {w}x{h} x{n} {len(s_gpu)} bytes")
    log(f"phase small_host: card == CPU, decode == recon: "
        f"{'; '.join(parts)} ({time.perf_counter() - t0:.3f} s)")


class _TwoLanes:
    """parallel.pictures with two leaf lanes on cuda:0 (the card is one
    device, where lane_devices lists one lane and the encoder runs no
    lanes), and every dispatch_leaf_batch call recorded as (pictures,
    synchronized seconds, kernel launches)."""

    def __enter__(self):
        import torch
        import svt_hevc_tpu_torch.parallel.pictures as pics
        self.pics = pics
        self.saved = (pics.lane_devices, pics.dispatch_leaf_batch)
        self.calls = []
        dispatch = pics.dispatch_leaf_batch

        def timed(enc, feat, items):
            torch.cuda.synchronize()
            c0, t0 = _launch_counts(), time.perf_counter()
            out = dispatch(enc, feat, items)
            torch.cuda.synchronize()
            self.calls.append((len(items), time.perf_counter() - t0,
                               _launch_counts() - c0))
            return out

        pics.lane_devices = lambda device: [torch.device("cuda", 0)] * 2
        pics.dispatch_leaf_batch = timed
        return self

    def __exit__(self, *exc):
        self.pics.lane_devices, self.pics.dispatch_leaf_batch = self.saved


def _launch_counts():
    from svt_hevc_tpu_torch.gpu import kernels as K
    return np.array([k.launches for k in _picture_kernels(K)])


def phase_leaves_1080p(results: dict):
    """The slice's full-width path: hierarchical low-delay P with its
    leaves in two lanes on the card. Per picture: the synchronized seconds
    of its encode_frame call (a leaf's: its download and host walk) and
    of the lane dispatch apart, and the kernel launches of each;
    libde265 decode == recon where present. The stream is held whole to
    JAX_1080P["leaves_1080p"], the JAX package's hl=1 stream, which is
    the same with mesh_pictures and without it; the port's CPU encode
    without lanes gives it too (the slow tests/test_torch_parity_1080p.py
    holds both packages to it). So the lanes change nothing, and no
    second encode without lanes is made here."""
    import torch
    from svt_hevc_tpu_torch import Encoder
    from svt_hevc_tpu_torch.gpu import kernels as K

    t_phase = time.perf_counter()
    n = LEAVES_FRAMES
    frames = make_frames(n, 1920, 1080, seed=7)
    names = [k.name for k in _picture_kernels(K)]
    enc = Encoder(_cfg(1920, 1080, **LEAVES_KW))
    rows = []
    encode_frame = enc.encode_frame

    def timed_frame(fr, **kw):
        torch.cuda.synchronize()
        c0, t0 = _launch_counts(), time.perf_counter()
        pic = encode_frame(fr, **kw)
        torch.cuda.synchronize()
        rows.append((kw["poc"], kw.get("precomputed") is not None,
                     time.perf_counter() - t0, _launch_counts() - c0))
        return pic

    enc.encode_frame = timed_frame
    torch.cuda.synchronize()
    K.reset_launches()
    t0 = time.perf_counter()
    with _TwoLanes() as lanes:
        aus = list(enc.encode_pictures(iter(frames)))
    t_enc = time.perf_counter() - t0
    totals = _launch_counts()
    stream = enc.headers() + b"".join(a.data for a in aus)
    check([a.poc for a in aus] == list(range(n)),
          f"leaves_1080p: output order {[a.poc for a in aus]}")
    check([c[0] for c in lanes.calls] == [2],
          f"leaves_1080p: lane groups {[c[0] for c in lanes.calls]}, not "
          f"one group of leaves 1 and 3")
    n_leaves, t_disp, c_disp = lanes.calls[0]
    per_leaf = c_disp // n_leaves
    check(list(per_leaf * n_leaves) == list(c_disp)
          and list(per_leaf) == [3, 13],
          f"leaves_1080p: launches per leaf {dict(zip(names, per_leaf))}")
    same = check_jax_stream("leaves_1080p", stream)
    de265 = _de265_to_recon(stream, aus, "leaves_1080p")
    for k, name in enumerate(names):
        results[name]["launches_leaves"] = int(totals[k])
        results[name]["launches_per_leaf"] = int(per_leaf[k])
    results["leaves_1080p"] = {
        "seconds": {f"{'leaf' if lf else 'P' if poc else 'I'}{poc}": dt
                    for poc, lf, dt, _ in rows},
        "dispatch_s": t_disp}
    log("  1080p M7 hl=1 with two lanes on cuda:0, per encode_frame call "
        "(synchronized s, launches " + "/".join(names) + "): "
        + ", ".join(f"{'leaf ' if lf else ''}"
                    f"{'I' if poc == 0 else 'P'}{poc} {dt:.3f} s "
                    f"{'/'.join(str(int(x)) for x in c)}"
                    for poc, lf, dt, c in rows))
    log(f"  lane dispatch: {len(lanes.calls)} call, {n_leaves} lanes, "
        f"{t_disp:.3f} s, launches per leaf "
        f"{dict(zip(names, map(int, per_leaf)))}; encode {t_enc:.3f} s; "
        f"PSNR-Y {_psnr([a.recon for a in aus], frames):.3f} dB, "
        f"{len(stream)} bytes, "
        f"{'libde265 decode == recon' if de265 else 'libde265 absent'}; "
        f"stream {same}")
    log(f"phase leaves_1080p: 1920x1080 x{n} hl=1 leaf lanes on the card "
        f"({time.perf_counter() - t_phase:.3f} s)")


def _bd_tool():
    """tools/torch_compare_reference (the BD artifacts' clip, config and
    PSNR)."""
    sys.path.insert(0, os.path.join(HERE, "tools"))
    import torch_compare_reference
    return torch_compare_reference


def _bd_setup():
    """(artifact row at BD_QP, config, frame count) of phase bd_1080p,
    from the artifact as the tool reads it."""
    tcr = _bd_tool()
    with open(os.path.join(HERE, BD_ARTIFACT)) as f:
        art = json.load(f)
    row = next(r for r in art["rows"] if r["qp"] == BD_QP)
    w, h = art["dims"]
    ps, hl = tcr.artifact_structure(art["pred_struct"])
    cfg = tcr.ours_config(w, h, BD_QP, art["preset"], art["intra_period"],
                          ps, hl)
    return row, cfg, art["frames"]


def _bd_clip(cfg, n):
    """The artifact's clip, as (y, cb, cr) per frame."""
    return _bd_tool().make_clip_scene(cfg.width, cfg.height, n, None)


def _plane_digests(frames) -> list[str]:
    """sha256 of each picture's three planes as int32."""
    out = []
    for f in frames:
        m = hashlib.sha256()
        for p in (f.y, f.cb, f.cr):
            m.update(np.ascontiguousarray(p, np.int32).tobytes())
        out.append(m.hexdigest())
    return out


def phase_bd_1080p(results: dict):
    """The BD artifacts' configuration at full width on the card: the
    artifact's clip at BD_QP, M7, CTB 64, IDR period 31, scene-cut off,
    IPPP. The stream must have the artifact's bytes and its recon the
    artifact's PSNR-Y; the IDR must run BD_IDR_STEPS wavefront steps and
    every P picture launch K1 and K2. Returns (stream, recon digests) for
    phase bd_check, which decodes the stream in a worker."""
    import torch
    from svt_hevc_tpu_torch import Encoder
    from svt_hevc_tpu_torch.gpu import intra_pass
    from svt_hevc_tpu_torch.gpu import kernels as K
    from svt_hevc_tpu_torch.io.yuv import Frame

    t_phase = time.perf_counter()
    tcr = _bd_tool()
    row, cfg, n = _bd_setup()
    clip = _bd_clip(cfg, n)
    check(cfg.ctb_size == 64 and not cfg.scene_change_detection
          and not cfg.code_eos_nal and cfg.pred_structure == 0,
          "bd_1080p: not the artifacts' configuration")
    frames = [Frame(y.astype(np.uint8), cb, cr) for y, cb, cr in clip]
    names = [k.name for k in _picture_kernels(K)]
    enc = Encoder(cfg)
    torch.cuda.synchronize()
    K.reset_launches()
    wf0 = dict(intra_pass.WAVEFRONT)
    snaps, times, aus = [], [], []
    t0 = time.perf_counter()
    for au in enc.encode_pictures(iter(frames)):
        times.append(time.perf_counter())
        snaps.append(_launch_counts())
        aus.append(au)
    totals = _launch_counts()
    runs = intra_pass.WAVEFRONT["runs"] - wf0["runs"]
    steps = intra_pass.WAVEFRONT["steps"] - wf0["steps"]
    # as in phase main: frames k >= 1 dispatch between the yields of AU
    # k-2 and AU k-1 (frames 0 and 1 both before AU 0)
    per_p = [snaps[0]] + [snaps[k - 1] - snaps[k - 2] for k in range(2, n)]
    types = "".join("IPB"[2 - a.slice_type] for a in aus)
    check(types == "I" + "P" * (n - 1), f"bd_1080p: picture types {types}")
    for i, c in enumerate(per_p, start=1):
        check(all(c > 0), f"bd_1080p P picture {i}: launches "
                          f"{dict(zip(names, c))}")
    check((runs, steps) == (1, BD_IDR_STEPS),
          f"bd_1080p: {runs} wavefront runs of {steps} steps, not one of "
          f"{BD_IDR_STEPS}")
    stream = enc.headers() + b"".join(a.data for a in aus)
    psnr = tcr.psnr_y([a.recon.y for a in aus], clip)
    check(len(stream) == row["ours_bytes"],
          f"bd_1080p: {len(stream)} bytes, artifact {row['ours_bytes']}")
    check(round(psnr, 3) == row["ours_psnr"],
          f"bd_1080p: recon PSNR-Y {psnr:.6f} dB, artifact "
          f"{row['ours_psnr']}")
    same = check_jax_stream("bd_1080p", stream)
    for k, name in enumerate(names):
        results[name]["launches_ctb64"] = int(totals[k])
        results[name]["launches_per_p_picture_ctb64"] = sorted(
            {int(c[k]) for c in per_p})
    idr = times[0] - t0
    # between the yields of AU k-1 and AU k: picture k's host walk and
    # picture k+1's dispatch (the last interval holds a walk only)
    p_s = np.diff(times)[:-1]
    results["bd_1080p"] = {"idr_s": idr, "p_s": [float(t) for t in p_s],
                           "wavefront_steps": steps}
    log(f"  1080p x{n} M7 qp {BD_QP} CTB 64 IDR period 31: IDR {idr:.3f} s "
        f"({steps} wavefront steps, {idr / steps * 1e3:.3f} ms per step, "
        f"with P1's dispatch), P {p_s.min():.3f}-{p_s.max():.3f} s "
        f"(median {np.median(p_s):.3f}, mean {p_s.mean():.3f}) per picture "
        f"between access units; {len(stream)} bytes (artifact "
        f"{row['ours_bytes']}), recon PSNR-Y {psnr:.6f} dB (artifact "
        f"{row['ours_psnr']}), stream {same}")
    log("  launches per P picture: " + ", ".join(
        f"{name} {sorted({int(c[k]) for c in per_p})}"
        for k, name in enumerate(names)))
    log(f"phase bd_1080p: 1920x1080 x{n} CTB 64 on the card, the "
        f"artifact's bytes and PSNR-Y ({time.perf_counter() - t_phase:.3f} "
        f"s)")
    return stream, _plane_digests([a.recon for a in aus])


def cpu_bd_decode(stream: bytes):
    """phase bd_1080p's stream through the port's decoder (in a worker):
    (digests of the decoded pictures, their PSNR-Y against the clip,
    seconds)."""
    from svt_hevc_tpu_torch.decoder.decoder import decode_stream
    t0 = time.perf_counter()
    dec = decode_stream(stream)
    _, cfg, n = _bd_setup()
    psnr = _bd_tool().psnr_y([d.y for d in dec], _bd_clip(cfg, n))
    return _plane_digests(dec), psnr, time.perf_counter() - t0


def phase_bd_check(digests, cpu):
    """The port's decoder gives back phase bd_1080p's recon, and its
    decode has the artifact's PSNR-Y."""
    t0 = time.perf_counter()
    row, _, _ = _bd_setup()
    dec, psnr, t_dec = cpu.result()
    check(dec == digests, "bd_1080p: decoded != recon")
    check(round(psnr, 3) == row["ours_psnr"],
          f"bd_1080p: decoded PSNR-Y {psnr:.6f} dB, artifact "
          f"{row['ours_psnr']}")
    log(f"phase bd_check: the bd_1080p stream decodes to its recon "
        f"({len(dec)} pictures, the port's decoder in a worker, "
        f"{t_dec:.3f} s), PSNR-Y {psnr:.6f} dB "
        f"({time.perf_counter() - t0:.3f} s)")


def phase_small_leaves():
    """The 512x256 leaf clips with two lanes on the card: the JAX
    package's sha256 (its stream with mesh_pictures and without, the
    same), decode == recon."""
    t0 = time.perf_counter()
    parts = []
    for name, (kw, n, sha_want, nbytes) in SMALL_LEAVES.items():
        frames = make_frames(n, 512, 256, seed=11)
        with _TwoLanes() as lanes:
            hdr, aus = _encode(frames, 512, 256, "cuda", mesh_pictures=True,
                               **kw)
        s_gpu = hdr + b"".join(a.data for a in aus)
        sha = hashlib.sha256(s_gpu).hexdigest()
        check(sha == sha_want and len(s_gpu) == nbytes,
              f"{name}: sha256 {sha} / {len(s_gpu)} bytes != reference")
        check(len(lanes.calls) > 0, f"{name}: no lane dispatch ran")
        _decodes_to_recon(s_gpu, aus, name)
        parts.append(f"{name} x{n} {len(s_gpu)} bytes, lane groups "
                     f"{[c[0] for c in lanes.calls]}")
    log(f"phase small_leaves: 512x256, two lanes on cuda:0, sha256 match "
        f"(the JAX stream with and without lanes), decode == recon: "
        f"{'; '.join(parts)} ({time.perf_counter() - t0:.3f} s)")


def _mesh_inputs(dev):
    """phase mesh's encode inputs on dev: (src3, ref3) stacks of MESH_B
    pictures (picture b+1 of make_frames(seed=13) against picture b)."""
    import torch
    fr = make_frames(MESH_B + 1, MESH_HW, MESH_HW, seed=13)

    def stack(frames, plane):
        return torch.stack([torch.from_numpy(
            getattr(f, plane).astype(np.int32)) for f in frames]).to(dev)

    src3 = tuple(stack(fr[1:], p) for p in ("y", "cb", "cr"))
    ref3 = tuple(stack(fr[:-1], p) for p in ("y", "cb", "cr"))
    return src3, ref3


def _mesh_steps(mesh, dev):
    """gop_encode_step and frontend_step of phase mesh on dev: (HME
    fields, packed buffers, analysis outputs, total)."""
    import torch
    from svt_hevc_tpu_torch.gpu.me import hme_search
    from svt_hevc_tpu_torch.parallel import mesh as M
    src3, ref3 = _mesh_inputs(dev)
    mvs = torch.stack([hme_search(src3[0][b], ref3[0][b])[0]
                       for b in range(MESH_B)])
    packed = M.gop_encode_step(mesh)(src3, ref3, mvs, 30, 31)
    out, total, first = M.frontend_step(mesh)(src3[0])
    check(first == 0 and np.isfinite(total), f"frontend_step: first "
          f"{first}, total {total}")
    return mvs, packed, out, total


def _init_group(backend: str, name: str):
    """A process group of world size 1 over backend, its file store under
    build/ (made afresh)."""
    from datetime import timedelta

    import torch.distributed as dist
    path = os.path.join(HERE, "build", name)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    if os.path.exists(path):
        os.remove(path)
    dist.init_process_group(backend, init_method=f"file://{path}", rank=0,
                            world_size=1, timeout=timedelta(seconds=120))


def cpu_mesh(_job):
    """The CPU side of phase mesh, in a worker process: the same steps
    over gloo with the plain versions. Returns (results, seconds)."""
    import torch
    import torch.distributed as dist
    from svt_hevc_tpu_torch.parallel import mesh as M
    torch.set_num_threads(CPU_THREADS)
    t0 = time.perf_counter()
    _init_group("gloo", "mesh_cpu.init")
    try:
        mvs, packed, out, total = _mesh_steps(M.make_mesh(), "cpu")
    finally:
        dist.destroy_process_group()
    return ({"mvs": mvs.numpy(), "packed": packed.numpy(),
             "modes": {k: v.numpy() for k, v in out.items()
                       if k.startswith("mode")}, "total": total},
            time.perf_counter() - t0)


@contextlib.contextmanager
def _plain_k1():
    """hme_search with K1's plain version (sad_field_ref) in the kernel's
    place, on whichever device its tensors are."""
    from svt_hevc_tpu_torch.gpu import kernels as K
    from svt_hevc_tpu_torch.gpu import me
    me.sad_field = K.sad_field_ref
    try:
        yield
    finally:
        me.sad_field = K.sad_field


def phase_mesh(results: dict, cpu):
    """parallel.mesh at world size 1 over NCCL on cuda:0: make_mesh's
    (1, 1) mesh; sharded_hme at 1920x1088 == hme_search of the
    edge-replicated slab (the halo of a one-tile mesh) run with K1's plain
    version, K1 == sad_field_ref on each of that slab's levels, and
    sharded_hme == the whole-picture hme_search on the interior block
    rows; gop_encode_step
    at 256x256 x2 == fast_p_fused_packed per picture on the card == the
    gloo run on the CPU; frontend_step's total finite and equal to the
    CPU's."""
    import torch
    import torch.distributed as dist
    from svt_hevc_tpu_torch.gpu import encode as genc
    from svt_hevc_tpu_torch.gpu import kernels as K
    from svt_hevc_tpu_torch.gpu.me import hme_search
    from svt_hevc_tpu_torch.parallel import mesh as M

    t0 = time.perf_counter()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    _init_group("nccl", "mesh_card.init")
    try:
        mesh = M.make_mesh()
        check(tuple(mesh.shape) == (1, 1)
              and mesh.mesh_dim_names == ("gop", "tile"),
              f"make_mesh: {tuple(mesh.shape)} {mesh.mesh_dim_names}")
        (r0, _, _), (s0, _, _) = _kernel_inputs(dev)
        torch.cuda.synchronize()
        K.reset_launches()
        mv_s, sad_s = M.sharded_hme(s0, r0, mesh)
        torch.cuda.synchronize()
        k1 = K.SAD_FIELD.launches
        check(k1 == 3 and K.MC_BLOCK.launches == 0,
              f"sharded_hme: K1 {k1}, K2 {K.MC_BLOCK.launches} launches")
        halo = M.HALO
        k = halo // 16
        slab_s = K.edge_pad(s0.float(), halo, halo, 0, 0)
        slab_r = K.edge_pad(r0.float(), halo, halo, 0, 0)
        nb = s0.shape[0] // 16
        # K1 against its plain version at the shapes sharded_hme gives it:
        # each level of the halo-extended slab (1216x1920 and its two
        # decimations), then the slab's whole search with the plain
        # version in K1's place, which sharded_hme's rows must equal
        slab_err = 0.0
        for name, s, r, rad in k1_levels(((slab_r, None, None),
                                          (slab_s, None, None))):
            got, want = K.sad_field(s, r, 16, rad), K.sad_field_ref(s, r, 16,
                                                                   rad)
            check(torch.equal(got, want), f"K1 != sad_field_ref on the "
                  f"sharded_hme slab's {name} {tuple(s.shape)} r={rad}")
            slab_err = max(slab_err, float((got - want).abs().max()))
        n_k1 = K.SAD_FIELD.launches
        with _plain_k1():
            mv_p, sad_p = hme_search(slab_s, slab_r)
        torch.cuda.synchronize()
        check(K.SAD_FIELD.launches == n_k1, "the plain hme_search launched "
              "K1")
        check(torch.equal(mv_s, mv_p[k:k + nb])
              and torch.equal(sad_s, sad_p[k:k + nb]),
              "sharded_hme != the plain hme_search of the edge-replicated "
              "slab")
        mv_e, sad_e = hme_search(slab_s, slab_r)
        check(torch.equal(mv_s, mv_e[k:k + nb])
              and torch.equal(sad_s, sad_e[k:k + nb]),
              "sharded_hme != hme_search of the edge-replicated slab")
        mv_g, sad_g = hme_search(s0, r0)
        check(torch.equal(mv_s[k:-k], mv_g[k:-k])
              and torch.equal(sad_s[k:-k], sad_g[k:-k]),
              "sharded_hme != hme_search on the interior block rows")
        edge_rows = int((mv_s != mv_g).any(-1).any(-1).sum())
        mvs, packed, out, total = _mesh_steps(mesh, dev)
        src3, ref3 = _mesh_inputs(dev)
        for b in range(MESH_B):
            want = genc.fast_p_fused_packed(
                src3[0][b], src3[1][b], src3[2][b], ref3[0][b], ref3[1][b],
                ref3[2][b], mvs[b], 30, 31, ctb_log2=5, w=MESH_HW,
                h=MESH_HW)
            check(torch.equal(packed[b], want),
                  f"gop_encode_step picture {b} != fast_p_fused_packed")
    finally:
        dist.destroy_process_group()
    got, t_cpu = cpu.result()
    check(np.array_equal(mvs.cpu().numpy(), got["mvs"]),
          "phase mesh: HME fields card != CPU")
    check(np.array_equal(packed.cpu().numpy(), got["packed"]),
          "gop_encode_step: card != CPU")
    for key, v in got["modes"].items():
        check(np.array_equal(out[key].cpu().numpy(), v),
              f"frontend_step {key}: card != CPU")
    check(abs(total - got["total"]) <= 1e-9 * abs(got["total"]),
          f"frontend_step total: card {total!r} != CPU {got['total']!r}")
    results["sad_field"]["launches_sharded_hme"] = int(k1)
    results["mc_block"]["launches_sharded_hme"] = 0
    log(f"phase mesh: NCCL world size 1, mesh (gop, tile) = (1, 1); "
        f"sharded_hme 1920x1088: {k1} K1 launches, K1 == sad_field_ref on "
        f"the 1216x1920 slab's three levels (max abs err {slab_err}), == "
        f"the plain and the kernel hme_search of the edge-replicated slab, "
        f"== the whole picture's on the interior "
        f"block rows ({edge_rows} edge block rows differ); gop_encode_step "
        f"{MESH_B} x {MESH_HW}x{MESH_HW} == fast_p_fused_packed per picture "
        f"== CPU (gloo); frontend_step total {total!r} == CPU (rtol 1e-9), "
        f"modes equal (CPU {t_cpu:.3f} s in a worker) "
        f"({time.perf_counter() - t0:.3f} s)")


# ------------------------------------------------------------ UHD phases

def _uhd_kernel_inputs(dev):
    """4320p main-path inputs: two consecutive 7680x4320 frames padded to
    the 64-aligned grid (7680x4352) like the encoder's upload."""
    from svt_hevc_tpu_torch.gpu import encode as genc
    w, h = UHD_SIZES["uhd_4320p_vbr"]
    fr = make_frames(2, w, h, seed=7)
    return [genc.prep_planes(f.y, f.cb, f.cr, w, -(-h // 64) * 64, dev)
            for f in fr]


def phase_kernels_uhd(results: dict):
    """Every kernel against its plain version on the card at 4320p shapes:
    K1 at the three hme_search levels of 7680x4352, K2's batched K=10
    luma launch (merge_snap's) on the 4320p plane, K3 at the two-level
    plan of the 4320p lookahead (34 x 60 window sums, 2 x 2 windows of
    32 x 32) over 289 * 3 columns (the uhd_4320p_vbr batch); each timed
    as in phase kernels."""
    import torch
    from svt_hevc_tpu_torch.gpu import analysis as ta
    from svt_hevc_tpu_torch.gpu import encode as genc
    from svt_hevc_tpu_torch.gpu import kernels as K

    t0 = time.perf_counter()
    dev = torch.device("cuda")
    planes = _uhd_kernel_inputs(dev)
    k1 = {"device_ms": 0.0, "call_ms": 0.0, "plain_ms": 0.0, "ops": 0.0,
          "bytes": 0.0}
    err = 0.0
    for name, src, ref, r in k1_levels(planes):
        out = K.sad_field(src, ref, 16, r)
        want = K.sad_field_ref(src, ref, 16, r)
        torch.cuda.synchronize()
        check(torch.equal(out, want), f"K1 4320p {name} differs from plain")
        err = max(err, float((out - want).abs().max()))
        nbytes, ops = k1_work(src, r)
        t = time_kernel(lambda a=(src, ref, 16, r): K.sad_field(*a),
                        lambda a=(src, ref, 16, r): K.sad_field_ref(*a),
                        nbytes, ops, plain_reps=2)
        h, w = src.shape
        log(f"  K1 sad_field 4320p {name} {h}x{w} r={r}: equal, {_fmt(t)}")
        for key in ("device_ms", "call_ms", "plain_ms"):
            k1[key] += t[key]
        k1["ops"] += ops
        k1["bytes"] += nbytes
    b, by = bound(k1["bytes"], k1["ops"])
    results["sad_field"]["uhd"] = {
        "shape": "7680x4352, 3 levels", "device_ms": k1["device_ms"],
        "call_ms": k1["call_ms"], "plain_ms": k1["plain_ms"],
        "bound_ms": b, "bound_by": by}
    results["sad_field"]["max_abs_err"] = max(
        results["sad_field"]["max_abs_err"], err)
    del src, ref, out, want

    lim = (genc.PAD - 9) * 4
    (y0, _, _), _ = planes
    nby, nbx = y0.shape[0] // 8, y0.shape[1] // 8
    mv = torch.from_numpy(k2_fields(10, nby, nbx, seed=6)).to(dev)
    ext = genc._ext_y(y0)
    out = genc._mc_luma(ext, mv, 8, True)
    args = k2_args(genc, "luma", ext, mv.clamp(-lim, lim), True, 8)
    want = K.mc_block_ref(*args)
    torch.cuda.synchronize()
    check(torch.equal(out, want), "K2 4320p batched luma K=10 differs")
    err = float((out - want).abs().max())
    del out, want
    nbytes, ops = k2_work(ext, args[1:5], *args[5:7])
    t = time_kernel(lambda a=args: K.mc_block(*a),
                    lambda a=args: K.mc_block_ref(*a), nbytes, ops,
                    plain_reps=2)
    results["mc_block"]["uhd"] = dict(t, shape=f"K=10 luma on "
                                      f"{y0.shape[1]}x{y0.shape[0]}")
    results["mc_block"]["max_abs_err"] = max(
        results["mc_block"]["max_abs_err"], err)
    log(f"  K2 mc_block 4320p batched luma bd=8 rounded K=10 on "
        f"{y0.shape[1]}x{y0.shape[0]}: equal, {_fmt(t)}")
    del planes, ext, mv, args

    q = ta.xla_reduce_plan(34, 60)
    rng = np.random.default_rng(9)
    parts = torch.from_numpy((rng.integers(0, 1 << 24, (289 * 3, 34 * 60))
                              / 16.0).astype(np.float32)).to(dev)
    out = K.ordered_sum(parts, q)
    want = K.ordered_sum_ref(parts, q)
    torch.cuda.synchronize()
    check(torch.equal(out, want), "K3 4320p two-level plan differs")
    t = time_kernel(lambda: K.ordered_sum(parts, q),
                    lambda: K.ordered_sum_ref(parts, q),
                    4 * (parts.numel() + out.numel()), parts.numel(),
                    plain_reps=2)
    results["ordered_sum"]["uhd"] = dict(
        t, shape=f"{parts.shape[0]} sums of 34 x 60, plan {tuple(q)}")
    results["ordered_sum"]["max_abs_err"] = max(
        results["ordered_sum"]["max_abs_err"],
        float((out - want).abs().max()))
    log(f"  K3 ordered_sum 4320p {parts.shape[0]} sums of 34 x 60 window "
        f"sums (plan {tuple(q)}): equal, {_fmt(t)}")
    log(f"phase kernels_uhd: K1 x3 levels, K2 K=10 luma, K3's two-level "
        f"plan at 4320p shapes equal to plain "
        f"({time.perf_counter() - t0:.3f} s)")


def uhd_lookahead_batch(frames) -> np.ndarray:
    """The uhd_4320p_vbr stream's one lookahead batch, as
    Encoder._la_complexities stacks it: the first picture (no
    predecessor), then every picture."""
    return np.stack([frames[0].y] + [f.y for f in frames]).astype(np.int32)


def uhd_cli_start(pool):
    """Write the uhd_4320p_vbr clip and start the command line on it in a
    subprocess on the card (chip_smoke.py --cli-probe), beside the 1080p
    phases, and the CPU's lookahead_stats of its batch in a worker:
    returns (process, paths, start time, frames, lookahead future)."""
    from svt_hevc_tpu_torch.io.yuv import write_yuv420
    w, h = UHD_SIZES["uhd_4320p_vbr"]
    frames = make_frames(UHD_FRAMES, w, h, seed=7)
    d = os.path.join(HERE, "build", "uhd_4320p_vbr")
    os.makedirs(d, exist_ok=True)
    path = {k: os.path.join(d, k)
            for k in ("in.yuv", "out.265", "rec.yuv", "probe.json")}
    write_yuv420(path["in.yuv"], frames)
    tokens = ["-i", path["in.yuv"], "-b", path["out.265"], "-o",
              path["rec.yuv"], *UHD_CLI_TOKENS]
    proc = subprocess.Popen([sys.executable, os.path.abspath(__file__),
                             "--cli-probe", path["probe.json"], "--",
                             *tokens], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, cwd=HERE)
    return (proc, path, time.perf_counter(), frames,
            pool.submit(cpu_uhd_lookahead))


def cpu_uhd_lookahead():
    """The port's lookahead_stats on the CPU (in a worker) of the
    uhd_4320p_vbr batch: {key: numpy array}, seconds."""
    import torch
    from svt_hevc_tpu_torch.gpu.analysis import lookahead_stats
    torch.set_num_threads(CPU_THREADS)
    w, h = UHD_SIZES["uhd_4320p_vbr"]
    ys = uhd_lookahead_batch(make_frames(UHD_FRAMES, w, h, seed=7))
    t0 = time.perf_counter()
    st = lookahead_stats(torch.from_numpy(ys))
    return {k: v.numpy() for k, v in st.items()}, time.perf_counter() - t0


def cpu_uhd_decode(stream: bytes):
    """A UHD stream through the port's decoder (in a worker): (digests of
    the decoded pictures in display order, seconds)."""
    from svt_hevc_tpu_torch.decoder.decoder import decode_stream
    t0 = time.perf_counter()
    dec = decode_stream(stream)
    return _plane_digests(dec), time.perf_counter() - t0


def phase_uhd_2160p(results: dict, pool):
    """main's configuration at 3840x2160 x UHD_FRAMES through
    Encoder.encode_pictures on the card: per access unit seconds, K1 / K2
    launches per P picture (all > 0), the IDR's wavefront steps, peak
    card memory, the stream == JAX_UHD; the decode check is submitted to
    a CPU worker (phase uhd_check). Returns (future, recon digests)."""
    import torch
    from svt_hevc_tpu_torch import Encoder, EncoderConfig
    from svt_hevc_tpu_torch.gpu import intra_pass
    from svt_hevc_tpu_torch.gpu import kernels as K

    t_phase = time.perf_counter()
    name = "uhd_2160p"
    w, h = UHD_SIZES[name]
    frames = make_frames(UHD_FRAMES, w, h, seed=7)
    enc = Encoder(EncoderConfig(**uhd_config_kw(name)))
    names = [k.name for k in _picture_kernels(K)]

    def counts():
        return np.array([k.launches for k in _picture_kernels(K)]
                        + [intra_pass.WAVEFRONT["steps"]])

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launches()
    intra_pass.WAVEFRONT.update(runs=0, steps=0)
    snaps, times = [counts()], []
    t_prev = time.perf_counter()
    aus = []
    for au in enc.encode_pictures(frames):
        aus.append(au)
        t_now = time.perf_counter()
        times.append(t_now - t_prev)
        snaps.append(counts())
        t_prev = t_now
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    check(len(aus) == UHD_FRAMES, f"{name}: {len(aus)} access units")
    # pictures are pipelined one deep: picture k >= 1 dispatches between
    # the yields of AU k-2 and AU k-1 (pictures 0 and 1 before AU 0)
    steps = [int(c[-1]) for c in np.diff(snaps, axis=0)]
    per_p = [snaps[1] - snaps[0]] + [snaps[k] - snaps[k - 1]
                                    for k in range(2, UHD_FRAMES)]
    for i, c in enumerate(per_p, start=1):
        check(all(c[:-1] > 0), f"{name} P picture {i}: launches "
              f"{dict(zip(names, c[:-1]))}")
    for k, kname in enumerate(names):
        results[kname]["launches_uhd_2160p"] = [int(c[k]) for c in per_p]
    stream = enc.headers() + b"".join(a.data for a in aus)
    same = check_jax_stream(name, stream)
    psnr = _psnr([a.recon for a in aus], frames)
    results[name] = {"au_seconds": times, "max_memory_allocated": peak,
                     "idr_wavefront_steps": steps[0]}
    log(f"  {w}x{h} x{UHD_FRAMES} M7 IPPP: access unit s "
        + " ".join(f"{t:.3f}" for t in times)
        + f" (the first holds the IDR, {sum(steps)} wavefront steps, and "
        f"the first P picture's dispatch); PSNR-Y {psnr:.3f} dB; "
        f"{len(stream)} bytes; peak card memory {peak / 2**30:.2f} GiB")
    log("  launches per P picture: " + ", ".join(
        f"{kname} {[int(c[k]) for c in per_p]}"
        for k, kname in enumerate(names)))
    log(f"  stream {same}")
    fut = pool.submit(cpu_uhd_decode, stream)
    log(f"phase uhd_2160p: {w}x{h} x{UHD_FRAMES} IPPP on the card "
        f"({time.perf_counter() - t_phase:.3f} s)")
    return fut, _plane_digests([a.recon for a in
                                sorted(aus, key=lambda a: a.display_idx)])


def phase_uhd_4320p_vbr(results: dict, started, pool):
    """The command line at 7680x4320 (UHD_CLI_TOKENS, started by
    uhd_cli_start beside the 1080p phases): per access unit seconds (the
    first with the lookahead batch and the IDR), K1 / K2 launches per P
    picture (all > 0), K3's launches in the lookahead (> 0: its batch's
    34 x 60 grid of window sums takes the two-level plan), QP per
    picture, kbit/s against -tbr, the subprocess's peak card memory, the
    CLI's file == JAX_UHD; lookahead_stats of the batch on the card ==
    the port on the CPU (a worker, every output), and the decode check
    submitted to a worker (phase uhd_check). Returns (decode future,
    recon digests)."""
    import torch
    from svt_hevc_tpu_torch.gpu import kernels as K
    from svt_hevc_tpu_torch.gpu.analysis import lookahead_stats
    from svt_hevc_tpu_torch.io.yuv import read_yuv

    t_phase = time.perf_counter()
    name = "uhd_4320p_vbr"
    w, h = UHD_SIZES[name]
    proc, path, t_start, frames, cpu_la = started
    ys = uhd_lookahead_batch(frames)
    out, err = proc.communicate(timeout=1200)
    t_cli = time.perf_counter() - t_start
    check(proc.returncode == 0, f"{name}: the command line failed: "
          f"{err[-3000:]}")
    with open(path["probe.json"]) as f:
        probe = json.load(f)
    rows = probe["rows"]
    with open(path["out.265"], "rb") as f:
        stream = f.read()
    recons = list(read_yuv(path["rec.yuv"], w, h))
    n = UHD_FRAMES
    check(len(rows) == n and len(recons) == n,
          f"{name}: {len(rows)} access units, {len(recons)} recons")
    names = [k.name for k in K.KERNELS]
    npk = len(_picture_kernels(K))
    p_rows = [row for row in rows if row["slice_type"] == 1]
    check(len(p_rows) == n - 1 and rows[0]["slice_type"] == 2,
          f"{name}: not one IDR and {n - 1} P pictures")
    for row in p_rows:
        check(all(c > 0 for c in row["counts"][:npk]),
              f"{name} P{row['poc']}: launches {row['counts'][:npk]}")
    k3 = sum(row["counts"][names.index("ordered_sum")] for row in rows)
    check(k3 > 0, f"{name}: K3 ordered_sum never launched")
    for k, kname in enumerate(names):
        results[kname]["launches_uhd_4320p_vbr"] = [row["counts"][k]
                                                   for row in rows]
    same = check_jax_stream(name, stream)
    qps = _slice_qps(stream)
    kbps = 8 * len(stream) * 30 / n / 1000.0
    tbr = int(UHD_CLI_TOKENS[UHD_CLI_TOKENS.index("-tbr") + 1])
    psnr = _psnr(recons, frames)
    peak = probe["max_memory_allocated"]
    results[name] = {"au_seconds": [row["seconds"] for row in rows],
                     "max_memory_allocated": peak,
                     "idr_wavefront_steps": rows[0]["counts"][len(names) + 1]}
    log(f"  {out.strip().splitlines()[-1]}")
    log(f"  {w}x{h} x{n} 8-bit M7 VBR via the command line ({t_cli:.3f} s "
        f"from its start): access unit s "
        + " ".join(f"{row['seconds']:.3f}" for row in rows)
        + f" (the first holds the lookahead batch and the IDR, "
        f"{results[name]['idr_wavefront_steps']} wavefront steps); QP per "
        f"picture {qps}; {kbps:.1f} kbit/s against -tbr {tbr / 1000:.1f}; "
        f"PSNR-Y {psnr:.3f} dB; {len(stream)} bytes; peak card memory "
        f"{peak / 2**30:.2f} GiB")
    log("  launches per access unit: " + ", ".join(
        f"{kname} {[row['counts'][k] for row in rows]}"
        for k, kname in enumerate(names)))
    log(f"  stream {same}")
    # the lookahead batch on the card == the port on the CPU
    torch.cuda.reset_peak_memory_stats()
    got = lookahead_stats(torch.from_numpy(ys).cuda())
    t_la = _time_lookahead(torch.from_numpy(ys).cuda())
    la_peak = torch.cuda.max_memory_allocated()
    want, t_cpu = cpu_la.result()
    for key in ("zz_sad", "gm_sad", "gm_mv", "hist", "variance"):
        check(np.array_equal(got[key].cpu().numpy(), want[key]),
              f"{name}: lookahead_stats {key}: card != CPU")
    results[name]["lookahead_ms"] = t_la * 1e3
    results[name]["lookahead_max_memory_allocated"] = la_peak
    log(f"  lookahead_stats of the {ys.shape[0]}-picture batch at {w}x{h}: "
        f"card == CPU (every output; the CPU in a worker, {t_cpu:.3f} s); "
        f"card {t_la * 1e3:.3f} ms per batch, peak card memory "
        f"{la_peak / 2**30:.2f} GiB; gm_sad {got['gm_sad'].tolist()}")
    fut = pool.submit(cpu_uhd_decode, stream)
    log(f"phase uhd_4320p_vbr: {w}x{h} x{n} VBR through the command line "
        f"on the card (waited {time.perf_counter() - t_phase:.3f} s)")
    return fut, _plane_digests(recons)


def phase_uhd_check(checks: dict):
    """The port's decoder (in CPU workers) gives back each UHD phase's
    recon."""
    t0 = time.perf_counter()
    for name, (fut, digests) in checks.items():
        dec, t_dec = fut.result()
        check(dec == digests, f"{name}: decoded != recon")
        log(f"  {name}: the port's decoder gives back the recon "
            f"({len(dec)} pictures, {t_dec:.3f} s in a worker)")
    log(f"phase uhd_check: both UHD streams decode to their recon "
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
    t_start = time.perf_counter()
    card = phase_card()
    phase_build()
    results: dict = {}
    phase_kernels(results)
    phase_kernels_uhd(results)
    phase_subpel()
    phase_main(results)
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor
    # the CPU references start beside the 1080p phases after main (the
    # benchmark's configuration, timed with nothing else on the host):
    # one thread each, so the workers and the main process fit the cores
    spawn = multiprocessing.get_context("spawn")
    pool = ProcessPoolExecutor(max_workers=CPU_WORKERS, mp_context=spawn)
    card_pool = bench_job = uhd_cli = None
    try:
        cpu = {name: pool.submit(cpu_reference, job)
               for name, job in cpu_jobs().items()}
        cpu_mesh_job = pool.submit(cpu_mesh, None)
        # the 4320p command line encodes beside the 1080p phases
        uhd_cli = uhd_cli_start(pool)
        phase_ra(results)
        phase_cli_1080p(results)
        host_job, host_card = phase_host_1080p(results)
        cpu_host = pool.submit(cpu_host_helpers, host_job)
        del host_job
        phase_leaves_1080p(results)
        bd_stream, bd_digests = phase_bd_1080p(results)
        cpu_bd = pool.submit(cpu_bd_decode, bd_stream)
        uhd_checks = {"uhd_2160p": phase_uhd_2160p(results, pool)}
        uhd_checks["uhd_4320p_vbr"] = phase_uhd_4320p_vbr(results, uhd_cli,
                                                          pool)
        bench_job = bench_check_start()
        card_pool = ProcessPoolExecutor(max_workers=CARD_WORKERS,
                                        mp_context=spawn,
                                        initializer=_card_worker_init)
        cards = card_jobs(card_pool)
        # the main process's own card phases, the leaf clips (which wait
        # for no CPU reference) first
        phase_small_leaves()
        phase_small(cpu["small"])
        phase_small_ra(cpu["small_ra"])
        phase_mesh(results, cpu_mesh_job)
        phase_small_new(cards["small_new"], cpu)
        phase_variants(cards["variants"],
                       [cpu[f"variant{i}"] for i in range(len(VARIANTS))])
        phase_stream_variants(cards["stream_variants"],
                              [cpu[f"stream_variant{i}"]
                               for i in range(len(STREAM_VARIANTS))])
        phase_small_host(cards["small_host"], cpu)
        phase_host_check(host_card, cpu_host)
        phase_bd_check(bd_digests, cpu_bd)
        phase_uhd_check(uhd_checks)
        phase_bench(bench_job)
    finally:
        procs = [*(bench_job[1] if bench_job is not None else ()),
                 *((uhd_cli[0],) if uhd_cli is not None else ())]
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
        for p in (card_pool, pool):
            if p is not None:
                p.shutdown(wait=True, cancel_futures=True)
    src = {"sad_field": ("svt_hevc_tpu_torch/csrc/sad_field.cu",
                         "svt_hevc_tpu/tpu/pallas_kernels.py:71"),
           "mc_block": ("svt_hevc_tpu_torch/csrc/mc_block.cu",
                        "svt_hevc_tpu/tpu/pallas_kernels.py:182"),
           # no Pallas kernel: XLA's float32 reduce of the lookahead SADs
           "ordered_sum": ("svt_hevc_tpu_torch/csrc/ordered_sum.cu",
                           "svt_hevc_tpu/tpu/analysis.py:233")}
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
               "launches_per_picture_host": r["launches_host"],
               "launches_leaves_1080p": r["launches_leaves"],
               "launches_per_leaf": r["launches_per_leaf"],
               "launches_sharded_hme": r["launches_sharded_hme"],
               "launches_ctb64": r["launches_ctb64"],
               "launches_per_p_picture_ctb64":
                   r["launches_per_p_picture_ctb64"],
               "launches_uhd_2160p": r["launches_uhd_2160p"],
               "launches_uhd_4320p_vbr": r["launches_uhd_4320p_vbr"]}
        keys = ("device_ms", "call_ms", "plain_ms", "bound_ms", "bound_by")
        row["bd10"] = {k: r["bd10"][k] for k in keys}
        row["uhd"] = {k: r["uhd"][k] for k in ("shape", *keys)}
        for launch in ("b_launch", "ctb64_launch"):
            if launch in r:
                row[launch] = {k: r[launch][k] for k in keys}
        rows.append(row)
    r = results["ordered_sum"]
    rows.append({"name": "ordered_sum", "route": "cuda",
                 "source": src["ordered_sum"][0],
                 "replaces": src["ordered_sum"][1],
                 "launches": r["launches"], "max_abs_err": r["max_abs_err"],
                 "ms": r["device_ms"], "device_ms": r["device_ms"],
                 "call_ms": r["call_ms"], "plain_ms": r["plain_ms"],
                 "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                 "library_ms": None, "launches_cli": r["launches_cli"],
                 "launches_uhd_4320p_vbr": r["launches_uhd_4320p_vbr"],
                 "uhd": {k: r["uhd"][k] for k in (
                     "shape", "device_ms", "call_ms", "plain_ms",
                     "bound_ms", "bound_by")}})
    log(f"card: {card}")
    log(f"chip_smoke.py: every phase passed in "
        f"{time.perf_counter() - t_start:.1f} s")
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
