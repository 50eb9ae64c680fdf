"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (one line each, with seconds; any failure exits nonzero):
  1. card      name / power limit (nvidia-smi) and versions
  2. build     nvcc builds of the CUDA kernels (csrc/), all at once, and
               the native host emitter (native/*.c, the system compiler)
  3. kernels   every kernel against its plain PyTorch version on the
               card at the 1080p main-path shapes (torch.equal), with
               CUDA-event times, the plain version's time and the bound
  4. small     512x256 x 10 frames, M7, qp 32, IPPP, on the card and on
               the CPU: streams byte-identical, equal to the reference
               sha256, decoded by the port's decoder to the recon
  5. variants  the other configurations the port accepts (presets M6,
               M10, M11; hierarchical low-delay P), 512x256 x 5 frames
               each: card stream == CPU stream, decoded to the recon
  6. main      1920x1080 x 8 frames, M7, qp 32, IPPP, on the card: IDR /
               first P / steady P seconds, kernel launches per P picture
               (all > 0), recon PSNR, and the I + P access units equal to
               a CPU encode of the first two frames
The line before the last is the kernel JSON, the last line the device
JSON. Imports nothing of JAX.
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

# H100 SXM peaks (NVIDIA data sheet): HBM rate and non-tensor fp32 rate;
# int32 multiply-adds are counted at the fp32 rate (no lower bound is
# tighter than the fastest ALU rate)
HBM_BYTES_PER_S = 3.35e12
ALU_OPS_PER_S = 67e12


def log(msg: str) -> None:
    print(msg, flush=True)


def make_frames(n, w, h, seed=7):
    """Synthetic content: textured luma and chroma with a global pan and a
    moving object (the repository benchmark's generator)."""
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


def cuda_ms(fn, reps: int) -> float:
    """Median milliseconds of fn() over reps runs, by CUDA events."""
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


def phase_kernels(results: dict):
    import torch
    from svt_hevc_tpu_torch.gpu import encode as genc
    from svt_hevc_tpu_torch.gpu import kernels as K
    from svt_hevc_tpu_torch.gpu.me import _decimate2

    t0 = time.perf_counter()
    dev = torch.device("cuda")
    planes = _kernel_inputs(dev)
    (y0, cb0, _cr0), (y1, _cb1, _cr1) = planes
    max_err = {"sad_field": 0.0, "mc_block": 0.0}

    # ---- K1 at the three hme_search levels
    s0, r0 = y1.float(), y0.float()
    s1, r1 = _decimate2(s0), _decimate2(r0)
    s2, r2 = _decimate2(s1), _decimate2(r1)
    k1 = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "ops": 0.0,
          "bytes": 0.0}
    for name, src, ref, r in (("level2", s2, r2, 8), ("level1", s1, r1, 4),
                              ("level0", s0, r0, 4)):
        out = K.sad_field(src, ref, 16, r)
        want = K.sad_field_ref(src, ref, 16, r)
        torch.cuda.synchronize()
        check(torch.equal(out, want), f"K1 {name} differs from plain")
        max_err["sad_field"] = max(max_err["sad_field"],
                                   float((out - want).abs().max()))
        ms = cuda_ms(lambda: K.sad_field(src, ref, 16, r), 20)
        pms = cuda_ms(lambda: K.sad_field_ref(src, ref, 16, r), 3)
        h, w = src.shape
        s2n = (2 * r + 1) ** 2
        nbytes = 4 * (2 * h * w + s2n * (h // 16) * (w // 16))
        ops = 3.0 * h * w * s2n
        b, by = bound(nbytes, ops)
        log(f"  K1 sad_field {name} {h}x{w} r={r}: equal, {ms:.4f} ms "
            f"(plain {pms:.4f} ms, bound {b:.4f} ms by {by})")
        k1["ms"] += ms
        k1["plain_ms"] += pms
        k1["ops"] += ops
        k1["bytes"] += nbytes

    # ---- K2: luma / chroma, rounded both ways, 8- and 10-bit, extreme MVs
    rng = np.random.default_rng(5)
    lim = (genc.PAD - 9) * 4
    nby, nbx = 1088 // 8, 1920 // 8
    mv = rng.integers(-lim - 64, lim + 65, (nby, nbx, 2)).astype(np.int32)
    mv[0, :, :] = lim
    mv[-1, :, :] = -lim
    mv[:, 0, 0] = lim + 40
    mv[:, -1, 1] = -lim - 40
    mv8 = torch.from_numpy(mv).to(dev)
    mv8c = mv8.clamp(-lim, lim)
    k2 = None
    for bd in (8, 10):
        ly = y0 if bd == 8 else (y0 << 2) + 3
        lc = cb0 if bd == 8 else (cb0 << 2) + 1
        ext_y, ext_c = genc._ext_y(ly), genc._ext_c(lc)
        for rounded in (False, True):
            for comp, ext, n, taps in (("luma", ext_y, 8, 8),
                                       ("chroma", ext_c, 4, 4)):
                if comp == "luma":
                    out = genc._mc_luma(ext, mv8, bd, rounded)
                    want = (genc._mc_pred_luma_direct if rounded
                            else genc._mc_raw_luma_direct)(ext, mv8c, bd)
                    maps = genc._luma_maps(mv8c)
                    pad = genc.PAD
                else:
                    out = genc._mc_chroma(ext, mv8, bd, rounded)
                    want = (genc._mc_pred_chroma_direct if rounded
                            else genc._mc_raw_chroma_direct)(ext, mv8c, bd)
                    maps = genc._chroma_maps(mv8c)
                    pad = genc.PAD // 2
                torch.cuda.synchronize()
                check(torch.equal(out, want),
                      f"K2 {comp} bd={bd} rounded={rounded} differs")
                max_err["mc_block"] = max(
                    max_err["mc_block"],
                    float((out - want).abs().max()))
                maps = [m.to(torch.int32).contiguous() for m in maps]
                args = (ext, *maps, n, taps, pad, rounded, bd)
                ms = cuda_ms(lambda a=args: K.mc_block(*a), 20)
                pms = cuda_ms(lambda a=args: K.mc_block_ref(*a), 3)
                hp, wp = ext.shape
                h, w = out.shape
                m = n + taps - 1
                nb = (h // n) * (w // n)
                nbytes = 4 * (hp * wp + 4 * nb + h * w)
                ops = 2.0 * nb * taps * (m * n + n * n)
                b, by = bound(nbytes, ops)
                log(f"  K2 mc_block {comp} bd={bd} rounded={rounded} "
                    f"ref_ext {hp}x{wp} -> {h}x{w}: equal, {ms:.4f} ms "
                    f"(plain {pms:.4f} ms, bound {b:.4f} ms by {by})")
                if comp == "luma" and rounded and bd == 8:
                    k2 = {"ms": ms, "plain_ms": pms, "bound_ms": b,
                          "bound_by": by}
    b1, by1 = bound(k1["bytes"], k1["ops"])
    results["sad_field"] = {"ms": k1["ms"], "plain_ms": k1["plain_ms"],
                            "bound_ms": b1, "bound_by": by1,
                            "max_abs_err": max_err["sad_field"]}
    results["mc_block"] = dict(k2, max_abs_err=max_err["mc_block"])
    log(f"phase kernels: K1 x3 levels, K2 x8 variants equal to plain "
        f"({time.perf_counter() - t0:.3f} s)")


def _encode(frames, w, h, device, n_aus=None, **kw):
    from svt_hevc_tpu_torch import Encoder, EncoderConfig
    cfg = EncoderConfig(**dict(dict(width=w, height=h, qp=32, enc_mode=7,
                                    intra_period=-1), **kw))
    enc = Encoder(cfg, device=device)
    aus = []
    for au in enc.encode_pictures(frames[:n_aus] if n_aus else frames):
        aus.append(au)
    return enc.headers(), aus


def _psnr(recons, frames) -> float:
    se = 0.0
    npx = 0
    for rec, fr in zip(recons, frames):
        d = np.asarray(rec.y, np.float64) - fr.y.astype(np.float64)
        se += float((d * d).sum())
        npx += d.size
    return 10 * np.log10(255.0 ** 2 * npx / max(se, 1e-9))


def phase_small():
    from svt_hevc_tpu_torch.decoder.decoder import decode_stream
    t0 = time.perf_counter()
    frames = make_frames(10, 512, 256, seed=11)
    hdr, aus = _encode(frames, 512, 256, "cuda")
    s_gpu = hdr + b"".join(a.data for a in aus)
    t1 = time.perf_counter()
    hdr_c, aus_c = _encode(frames, 512, 256, "cpu")
    s_cpu = hdr_c + b"".join(a.data for a in aus_c)
    t2 = time.perf_counter()
    check(s_gpu == s_cpu, "small clip: card stream != CPU stream")
    sha = hashlib.sha256(s_gpu).hexdigest()
    check(sha == SMALL_SHA256 and len(s_gpu) == SMALL_BYTES,
          f"small clip: sha256 {sha} / {len(s_gpu)} bytes != reference")
    dec = decode_stream(s_gpu)
    check(len(dec) == len(aus), "small clip: decoded picture count")
    for d, a in zip(dec, aus):
        check(np.array_equal(d.y, a.recon.y)
              and np.array_equal(d.cb, a.recon.cb)
              and np.array_equal(d.cr, a.recon.cr),
              "small clip: decoded != recon")
    log(f"phase small: 512x256 x10 {len(s_gpu)} bytes, sha256 match, "
        f"card == CPU, decode == recon, PSNR-Y "
        f"{_psnr([a.recon for a in aus], frames):.3f} dB; card "
        f"{t1 - t0:.3f} s, CPU {t2 - t1:.3f} s "
        f"({time.perf_counter() - t0:.3f} s)")


def phase_variants():
    from svt_hevc_tpu_torch.decoder.decoder import decode_stream
    t0 = time.perf_counter()
    frames = make_frames(5, 512, 256, seed=11)
    parts = []
    for kw in (dict(enc_mode=6), dict(enc_mode=10), dict(enc_mode=11),
               dict(hierarchical_levels=2)):
        name = ",".join(f"{k}={v}" for k, v in kw.items())
        hdr, aus = _encode(frames, 512, 256, "cuda", **kw)
        s_gpu = hdr + b"".join(a.data for a in aus)
        hdr_c, aus_c = _encode(frames, 512, 256, "cpu", **kw)
        check(s_gpu == hdr_c + b"".join(a.data for a in aus_c),
              f"variant {name}: card stream != CPU stream")
        dec = decode_stream(s_gpu)
        check(len(dec) == len(aus), f"variant {name}: decoded count")
        for d, a in zip(dec, aus):
            check(np.array_equal(d.y, a.recon.y)
                  and np.array_equal(d.cb, a.recon.cb)
                  and np.array_equal(d.cr, a.recon.cr),
                  f"variant {name}: decoded != recon")
        parts.append(f"{name} {len(s_gpu)} bytes")
    log(f"phase variants: 512x256 x5, card == CPU, decode == recon: "
        f"{'; '.join(parts)} ({time.perf_counter() - t0:.3f} s)")


def phase_main(results: dict):
    import torch
    from svt_hevc_tpu_torch import Encoder, EncoderConfig
    from svt_hevc_tpu_torch.gpu import kernels as K

    t_phase = time.perf_counter()
    n = 8
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
    t1 = time.perf_counter()
    _, aus_c = _encode(frames, 1920, 1080, "cpu", n_aus=2)
    t_cpu = time.perf_counter() - t1
    for i in range(2):
        check(aus[i].data == aus_c[i].data,
              f"1080p AU {i}: card bytes != CPU bytes")
    log(f"phase main: 1920x1080 x{n} on the card, I + P access units == "
        f"CPU encode (CPU {t_cpu:.3f} s) "
        f"({time.perf_counter() - t_phase:.3f} s)")


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
    phase_small()
    phase_variants()
    phase_main(results)
    src = {"sad_field": ("svt_hevc_tpu_torch/csrc/sad_field.cu",
                         "svt_hevc_tpu/tpu/pallas_kernels.py:71"),
           "mc_block": ("svt_hevc_tpu_torch/csrc/mc_block.cu",
                        "svt_hevc_tpu/tpu/pallas_kernels.py:182")}
    rows = []
    for name in ("sad_field", "mc_block"):
        r = results[name]
        rows.append({"name": name, "route": "cuda", "source": src[name][0],
                     "replaces": src[name][1], "launches": r["launches"],
                     "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                     "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                     "bound_by": r["bound_by"], "library_ms": None})
    log(f"card: {card}")
    log(json.dumps({"kernels": rows}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
