"""The PyTorch/CUDA port against the recorded BD-rate artifacts.

    python3 tools/torch_compare_reference.py --artifact BD_r05_cif_ipp.json
                                             [--device cuda|cpu]
                                             [--decoder port|de265]

Re-encodes the clip of a BD_*.json artifact (make_clip_scene, or
make_clip for content "noise", at the artifact's dims and frame count) with the port at each of its rows' QPs,
with the artifact's preset, intra period and prediction structure, CTB 64
and no scene-cut detection (the settings every artifact was made with),
decodes each stream, and prints bytes, PSNR-Y and seconds per row and the
Bjontegaard delta rate against the artifact's reference points
(ref_bytes / ref_psnr). Exits nonzero unless every row's bytes equal the
artifact's ours_bytes, its PSNR-Y rounded to 3 decimals equals ours_psnr,
and the artifact's bd_rate_pct lies within what the rows allow (see
bd_rate_bounds). The last line is one JSON object with the rows and, on
the card, its name and power limit as nvidia-smi gives them.

--device: the encoder's device (default cuda; without a CUDA device the
encoder raises, it does not fall back to the CPU). --decoder: the port's
own decoder (default) or libde265 through the port's binding, which
raises where the library is not installed.

The twin of tools/compare_reference.py's half that runs this encoder,
with its own copies of make_clip_scene, make_clip and bd_rate (it imports
nothing of the JAX package). Not ported: run_ref and the reference half of
main (with tools/build_reference.sh and tools/ref_asm_stubs.c), which need
the reference encoder's source tree; the reference points come from the
artifacts instead. Nor tools/bd_sweep.py's decision-constant overrides
through environment variables: the port reads no environment, and its
constants are the JAX package's defaults.
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def make_clip_scene(w, h, n, path):
    """Structured synthetic content: smooth sky gradient, textured ground,
    high-contrast structures, and three moving objects at mixed (incl.
    fractional-effective) velocities — closer to camera video than the
    pure-noise pan of make_clip. Writes the 4:2:0 clip to path (nothing
    where path is None) and returns (y int64, cb, cr) per frame."""
    rng = np.random.default_rng(9)
    H, W = h + 96, w + 96
    yy, xx = np.mgrid[0:H, 0:W]
    sky = 60 + 90 * (yy / H)
    tex = rng.integers(0, 256, (H, W)).astype(np.float32)
    for _ in range(3):
        tex = (tex + np.roll(tex, 1, 0) + np.roll(tex, 1, 1)
               + np.roll(tex, -1, 0) + np.roll(tex, -1, 1)) / 5
    ground = 80 + 0.5 * (tex - tex.mean())
    base = np.where(yy > 0.6 * H, ground, sky)
    # static structures: bars and blocks
    for k in range(6):
        x0 = (97 * k) % (W - 80)
        base[H // 3:H // 3 + 40 + 8 * k, x0:x0 + 24] = 30 + 30 * (k % 3)
    frames = []
    with open(os.devnull if path is None else path, "wb") as f:
        for i in range(n):
            ox, oy = (3 * i) % 64, (1 * i) % 48
            y = base[oy:oy + h, ox:ox + w].astype(np.float32).copy()
            # moving objects: slow smooth disc, fast small block, drifter
            cx, cy = (40 + 5 * i) % (w - 80), int(h * 0.3)
            ygrid, xgrid = np.mgrid[0:h, 0:w]
            disc = ((xgrid - cx - 40) ** 2 + (ygrid - cy - 40) ** 2) < 35 ** 2
            y[disc] = 200 - (i % 7)
            bx, by = (11 * i) % (w - 32), (h // 2 + 3 * i) % (h - 32)
            y[by:by + 24, bx:bx + 24] = 16
            y = np.clip(y, 0, 255).astype(np.uint8)
            cb = np.full((h // 2, w // 2), 118, np.uint8)
            cb[by // 2:by // 2 + 12, bx // 2:bx // 2 + 12] = 90
            cr = np.full((h // 2, w // 2), 130, np.uint8)
            f.write(y.tobytes()); f.write(cb.tobytes()); f.write(cr.tobytes())
            frames.append((y.astype(np.int64), cb, cr))
    return frames


def make_clip(w, h, n, path):
    """A smoothed-noise pan with a moving brighter square; writes the
    4:2:0 clip to path and returns (y, cb, cr) per frame."""
    rng = np.random.default_rng(5)
    base = rng.integers(0, 256, (h + 64, w + 64)).astype(np.float32)
    for _ in range(2):
        base = (base + np.roll(base, 1, 0) + np.roll(base, 1, 1)) / 3
    frames = []
    with open(path, "wb") as f:
        for i in range(n):
            y = base[i % 32:i % 32 + h, (2 * i) % 32:(2 * i) % 32 + w]
            y = y.astype(np.uint8).copy()
            sx, sy = (7 * i) % (w - 64), (5 * i) % (h - 64)
            y[sy:sy + 48, sx:sx + 48] = (
                base[sy:sy + 48, sx:sx + 48] * 0.5 + 90).astype(np.uint8)
            cb = np.full((h // 2, w // 2), 120, np.uint8)
            cr = np.full((h // 2, w // 2), 130, np.uint8)
            f.write(y.tobytes())
            f.write(cb.tobytes())
            f.write(cr.tobytes())
            frames.append((y, cb, cr))
    return frames


def decode_luma(stream: bytes, decoder: str = "port"):
    """The decoded luma planes in output order: "port" (the port's
    decoder) or "de265" (libde265 through the port's binding; raises
    where it is absent)."""
    if decoder == "port":
        from svt_hevc_tpu_torch.decoder.decoder import decode_stream
        return [d.y for d in decode_stream(stream)]
    if decoder == "de265":
        from svt_hevc_tpu_torch.io.de265_decoder import decode_annexb
        return [y for y, _, _ in decode_annexb(stream)]
    raise ValueError(f"unknown decoder {decoder!r}")


def psnr_y(lumas, frames):
    """PSNR-Y of the luma planes against the source frames' lumas, over
    all their samples."""
    if len(lumas) != len(frames):
        raise RuntimeError(f"{len(lumas)} pictures, not {len(frames)}")
    num = den = 0.0
    for dy, (sy, _, _) in zip(lumas, frames):
        num += float(((dy.astype(np.int64) - sy.astype(np.int64)) ** 2)
                     .sum())
        den += dy.size
    mse = num / den
    return 10 * np.log10(255.0 ** 2 / max(mse, 1e-12))


def psnr_stream(stream, frames, decoder="port"):
    """PSNR-Y of the decoded stream against the source frames."""
    return psnr_y(decode_luma(stream, decoder), frames)


def bd_rate(r1, p1, r2, p2):
    """Bjontegaard delta rate of (r2, p2) vs anchor (r1, p1): % bitrate
    change at equal quality (negative = anchor beaten)."""
    lr1, lr2 = np.log10(r1), np.log10(r2)
    c1 = np.polyfit(p1, lr1, 3)
    c2 = np.polyfit(p2, lr2, 3)
    lo = max(min(p1), min(p2))
    hi = min(max(p1), max(p2))
    i1 = np.polyint(c1)
    i2 = np.polyint(c2)
    avg1 = (np.polyval(i1, hi) - np.polyval(i1, lo)) / (hi - lo)
    avg2 = (np.polyval(i2, hi) - np.polyval(i2, lo)) / (hi - lo)
    return (10 ** (avg2 - avg1) - 1) * 100.0


def bd_rate_bounds(r1, p1, r2, p2, half1, half2):
    """The least and the most bd_rate(r1, p1', r2, p2') where every p1' is
    within half1 of p1 and every p2' within half2 of p2: the BD-rate's
    range under PSNR values rounded to that half-width (an artifact keeps
    them to 3 decimals, half-width 5e-4). The corners of the box; within
    so small a box the function is linear to far below the rounding."""
    p1, p2 = np.asarray(p1, float), np.asarray(p2, float)
    vals = [bd_rate(r1, p1 + half1 * np.array(s1), r2,
                    p2 + half2 * np.array(s2))
            for s1 in itertools.product((-1, 1), repeat=len(p1))
            for s2 in itertools.product((-1, 1), repeat=len(p2))]
    return min(vals), max(vals)


def ours_config(w, h, qp, preset, intra_period=-1, pred_struct=0,
                hierarchical_levels=None):
    """The port's config of run_ours: CTB 64 and no scene-cut detection;
    pred_struct 2 is random access (hierarchical_levels default 3), a
    low-delay pred_struct 0 with hierarchical_levels is hierarchical
    low-delay P, else flat IPPP."""
    from svt_hevc_tpu_torch import EncoderConfig
    kw = {}
    if pred_struct == 2:
        kw = dict(pred_structure=2,
                  hierarchical_levels=(hierarchical_levels
                                       if hierarchical_levels is not None
                                       else 3))
    elif hierarchical_levels:
        kw = dict(pred_structure=0, hierarchical_levels=hierarchical_levels)
    # CTB 64 anchors the comparison at the reference encoder's LCU size
    return EncoderConfig(width=w, height=h, qp=qp, enc_mode=preset,
                         intra_period=intra_period, ctb_size=64,
                         scene_change_detection=False, **kw)


def run_ours(clip, w, h, n, qp, preset, intra_period=-1,
             pred_struct=0, hierarchical_levels=None, device="cuda"):
    """Encode the first n frames of the 4:2:0 clip file with the port on
    device; returns (stream bytes, encode seconds)."""
    from svt_hevc_tpu_torch import Encoder
    from svt_hevc_tpu_torch.io.yuv import read_yuv420
    enc = Encoder(ours_config(w, h, qp, preset, intra_period, pred_struct,
                              hierarchical_levels), device=device)
    frames = list(read_yuv420(clip, w, h, max_frames=n))
    t0 = time.perf_counter()
    stream, _ = enc.encode(frames)
    dt = time.perf_counter() - t0
    return bytes(stream), dt


def artifact_structure(pred_struct: str):
    """(pred_struct, hierarchical_levels) of an artifact's pred_struct
    string, as compare_reference.main wrote it: "IPPP-matched" or
    "RA-hierB(hl=N)-matched"."""
    if pred_struct == "IPPP-matched":
        return 0, 0
    m = re.fullmatch(r"RA-hierB\(hl=(\d+)\)-matched", pred_struct)
    if m is None:
        raise ValueError(f"unknown pred_struct {pred_struct!r}")
    return 2, int(m.group(1))


def card_line(device: str) -> str | None:
    """nvidia-smi's name and power limit of the card (None on the CPU)."""
    if not device.startswith("cuda"):
        return None
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()


def check_artifact(art: dict, rows: list[dict]):
    """(BD-rate of rows against the artifact's reference points, its
    bounds under 3-decimal reference PSNR, failures). rows: qp, bytes,
    psnr (unrounded) per artifact row."""
    fails = []
    for want, got in zip(art["rows"], rows):
        if got["bytes"] != want["ours_bytes"]:
            fails.append(f"qp {want['qp']}: {got['bytes']} bytes, artifact "
                         f"{want['ours_bytes']}")
        if round(got["psnr"], 3) != want["ours_psnr"]:
            fails.append(f"qp {want['qp']}: PSNR-Y {got['psnr']:.3f} dB, "
                         f"artifact {want['ours_psnr']}")
    ref_r = np.array([r["ref_bytes"] for r in art["rows"]], float)
    ref_p = np.array([r["ref_psnr"] for r in art["rows"]], float)
    r = np.array([x["bytes"] for x in rows], float)
    p = np.array([x["psnr"] for x in rows], float)
    bd = bd_rate(ref_r, ref_p, r, p)
    # the artifact's BD-rate came from unrounded PSNR on both sides and
    # was rounded to 2 decimals; the reference PSNR is kept to 3
    lo, hi = bd_rate_bounds(ref_r, ref_p, r, p, 5e-4, 0.0)
    if not lo - 0.005 <= art["bd_rate_pct"] <= hi + 0.005:
        fails.append(f"BD-rate {bd:+.4f}% (range {lo:+.4f}..{hi:+.4f}% "
                     f"under the reference PSNR's rounding), artifact "
                     f"{art['bd_rate_pct']:+.2f}%")
    return bd, (lo, hi), fails


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--artifact", required=True,
                    help="a BD_*.json written by compare_reference.py")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--decoder", choices=("port", "de265"), default="port")
    args = ap.parse_args()
    import warnings
    # a cubic through 3 rows is underdetermined: polyfit warns, and takes
    # the least-norm fit, as the artifacts' BD-rates did
    warnings.filterwarnings("ignore", "Polyfit may be poorly conditioned")
    with open(args.artifact) as f:
        art = json.load(f)
    w, h = art["dims"]
    n, ip, preset = art["frames"], art["intra_period"], art["preset"]
    ps, hl = artifact_structure(art["pred_struct"])
    card = card_line(args.device)
    if card:
        print(f"card: {card}", flush=True)
    rows = []
    with tempfile.TemporaryDirectory() as tmp:
        clip = os.path.join(tmp, "scene.yuv")
        gen = make_clip if art.get("content") == "noise" else make_clip_scene
        frames = gen(w, h, n, clip)
        for want in art["rows"]:
            qp = want["qp"]
            stream, dt = run_ours(clip, w, h, n, qp, preset, ip,
                                  pred_struct=ps, hierarchical_levels=hl,
                                  device=args.device)
            psnr = psnr_stream(stream, frames, args.decoder)
            rows.append({"qp": qp, "bytes": len(stream), "psnr": psnr,
                         "seconds": dt})
            print(f"qp {qp:>2}: {len(stream)} bytes (artifact "
                  f"{want['ours_bytes']}), PSNR-Y {psnr:.6f} dB (artifact "
                  f"{want['ours_psnr']}), {dt:.3f} s on {args.device}",
                  flush=True)
    bd, (lo, hi), fails = check_artifact(art, rows)
    print(f"BD-rate vs the artifact's reference points: {bd:+.4f}% "
          f"(range {lo:+.4f}..{hi:+.4f}% under the reference PSNR's "
          f"3-decimal rounding; artifact {art['bd_rate_pct']:+.2f}%)")
    for msg in fails:
        print(f"MISMATCH: {msg}")
    print(json.dumps({"artifact": os.path.basename(args.artifact),
                      "card": card, "device": args.device,
                      "decoder": args.decoder, "rows": rows,
                      "bd_rate_pct": bd, "bd_bounds": [lo, hi],
                      "ok": not fails}), flush=True)
    return 1 if fails else 0


if __name__ == "__main__":
    sys.exit(main())
