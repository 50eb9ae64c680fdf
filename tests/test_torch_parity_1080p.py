"""Every 1080p stream that chip_smoke.py encodes on the card, encoded
whole on the CPU by the JAX package and by the port, each held to the
bytes and sha256 that chip_smoke.py records for it (JAX_1080P).

The configurations (chip_smoke.py's phases; make_frames is
chip_smoke.make_frames):

- main: 1920x1080 x5 of make_frames(seed=7), M7, qp 32, IPPP, 50 fps
  (tools/torch_bench.bench_config);
- bench: the same at the benchmark's 64 frames (tools/torch_bench.py);
- ra: main's clip and configuration with random access, hl=2;
- cli_1080p: the command line's file (CLI_TOKENS: 10-bit M8 VBR) of
  make_frames(5, seed=7, patches=True, bit_depth=10);
- host_1080p: x3 with 2x2 tiles and -sharp (HOST_KW);
- leaves_1080p: x5 hl=1 with mesh_pictures (LEAVES_KW);
- bd_1080p: BD_r05_1080p_ipp.json's clip and configuration at qp 32
  (CTB 64, IDR period 31, scene-cut off), x24.

Beside them, the JAX package's streams of chip_smoke.py's 512x256 leaf
clips (SMALL_LEAVES: hl=1 x10, hl=2 with intra_period=7 x14), with
mesh_pictures on the 8 virtual devices and without it: both equal the
recorded sha256, which is how the card's lane stream, held to it, is
also held to the stream without lanes.

Marked slow (Tier-1 runs -m 'not slow'); one configuration takes 0.5 to
10 minutes per package on the CPU:

    JAX_COMPILATION_CACHE_DIR= python -m pytest -m slow \
        tests/test_torch_parity_1080p.py

As a script it encodes the named configurations with one package and
prints one JSON line per stream (name, package, bytes, sha256, seconds):

    JAX_COMPILATION_CACHE_DIR= python tests/test_torch_parity_1080p.py \
        --package jax main ra

(a leaf clip's name prints its JAX stream without and with
mesh_pictures).

The JAX package's float32 reductions are compiled for the host's vector
ISA; chip_smoke.py's comment on JAX_1080P says under which ISAs the
constants were made.
"""

import argparse
import functools
import hashlib
import json
import os
import sys
import tempfile
import time

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402

NAMES = tuple(chip_smoke.JAX_1080P)
LEAF_NAMES = tuple(chip_smoke.SMALL_LEAVES)


def _bench_frames():
    return chip_smoke._bench_tool().MAX_FRAMES


def clip(name: str) -> list:
    """The configuration's frames as (y, cb, cr) numpy planes."""
    if name == "bd_1080p":
        _, cfg, n = chip_smoke._bd_setup()
        return [(y.astype(np.uint8), cb, cr)
                for y, cb, cr in chip_smoke._bd_clip(cfg, n)]
    n = {"main": 5, "bench": _bench_frames(), "ra": 5,
         "cli_1080p": chip_smoke.CLI_FRAMES,
         "host_1080p": chip_smoke.HOST_FRAMES,
         "leaves_1080p": chip_smoke.LEAVES_FRAMES}[name]
    fkw = (dict(patches=True, bit_depth=10) if name == "cli_1080p" else {})
    return [(f.y, f.cb, f.cr)
            for f in chip_smoke.make_frames(n, 1920, 1080, seed=7, **fkw)]


def config_kw(name: str) -> dict:
    """The EncoderConfig keywords of every configuration but cli_1080p."""
    if name == "bd_1080p":
        _, cfg, _ = chip_smoke._bd_setup()
        return {k: getattr(cfg, k) for k in cfg.__dataclass_fields__}
    kw = dict(width=1920, height=1080, qp=32, enc_mode=7, intra_period=-1,
              fps_num=50)
    kw.update({"ra": chip_smoke.RA_KW, "host_1080p": chip_smoke.HOST_KW,
               "leaves_1080p": chip_smoke.LEAVES_KW}.get(name, {}))
    return kw


def _cli_stream(package: str, planes) -> bytes:
    """The command line's output file for planes (10-bit 4:2:0 raw in)."""
    if package == "jax":
        from svt_hevc_tpu import app
        from svt_hevc_tpu.io.yuv import Frame, write_yuv420
        extra = []
    else:
        from svt_hevc_tpu_torch import app
        from svt_hevc_tpu_torch.io.yuv import Frame, write_yuv420
        extra = ["-device", "cpu"]
    with tempfile.TemporaryDirectory() as d:
        src, out = os.path.join(d, "in.yuv"), os.path.join(d, "out.265")
        write_yuv420(src, [Frame(y=y, cb=cb, cr=cr) for y, cb, cr in planes])
        rc = app.main(["-i", src, "-b", out, *chip_smoke.CLI_TOKENS, *extra])
        assert rc == 0
        with open(out, "rb") as f:
            return f.read()


def stream(package: str, name: str) -> bytes:
    """The whole stream of configuration name from package ("jax" or
    "port", the port on the CPU): parameter sets and every access unit,
    or for cli_1080p the file the command line writes."""
    planes = clip(name)
    if name == "cli_1080p":
        return _cli_stream(package, planes)
    if package == "jax":
        from svt_hevc_tpu.config import EncoderConfig
        from svt_hevc_tpu.io.yuv import Frame
        from svt_hevc_tpu.pipeline.encoder import Encoder
        enc = Encoder(EncoderConfig(**config_kw(name)))
    else:
        from svt_hevc_tpu_torch import Encoder, EncoderConfig
        from svt_hevc_tpu_torch.io.yuv import Frame
        enc = Encoder(EncoderConfig(**config_kw(name)), device="cpu")
    frames = [Frame(y=y, cb=cb, cr=cr) for y, cb, cr in planes]
    aus = [a.data for a in enc.encode_pictures(iter(frames))]
    assert len(aus) == len(frames)
    return enc.headers() + b"".join(aus)


def leaf_stream(name: str, mesh: bool) -> bytes:
    """The JAX package's whole stream of the small leaf clip name
    (chip_smoke.SMALL_LEAVES; 512x256, qp 32, M7, make_frames(seed=11)),
    with mesh_pictures or without."""
    from svt_hevc_tpu.config import EncoderConfig
    from svt_hevc_tpu.io.yuv import Frame
    from svt_hevc_tpu.pipeline.encoder import Encoder
    kw, n, _, _ = chip_smoke.SMALL_LEAVES[name]
    enc = Encoder(EncoderConfig(**dict(
        dict(width=512, height=256, qp=32, enc_mode=7, intra_period=-1,
             fps_num=50, mesh_pictures=mesh), **kw)))
    frames = [Frame(y=f.y, cb=f.cb, cr=f.cr)
              for f in chip_smoke.make_frames(n, 512, 256, seed=11)]
    return enc.headers() + b"".join(
        a.data for a in enc.encode_pictures(iter(frames)))


def digest(s: bytes) -> tuple:
    return len(s), hashlib.sha256(s).hexdigest()


@pytest.mark.slow
@pytest.mark.parametrize("package", ["jax", "port"])
@pytest.mark.parametrize("name", NAMES)
def test_1080p_stream_equals_the_recorded_jax_stream(name, package):
    if package == "port":
        import torch
        torch.set_num_threads(min(4, os.cpu_count() or 1))
    assert digest(stream(package, name)) == chip_smoke.JAX_1080P[name]


@pytest.mark.slow
@pytest.mark.parametrize("mesh", [False, True])
@pytest.mark.parametrize("name", LEAF_NAMES)
def test_small_leaf_clip_jax_stream_equals_the_recorded_stream(name, mesh):
    _, _, sha, n = chip_smoke.SMALL_LEAVES[name]
    assert digest(leaf_stream(name, mesh)) == (n, sha)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--package", choices=["jax", "port"], required=True)
    ap.add_argument("names", nargs="+", choices=NAMES + LEAF_NAMES)
    args = ap.parse_args(argv)
    if args.package == "jax":
        os.environ.setdefault("JAX_PLATFORMS", "cpu")
        flags = os.environ.get("XLA_FLAGS", "")
        if "xla_force_host_platform_device_count" not in flags:
            os.environ["XLA_FLAGS"] = (
                flags + " --xla_force_host_platform_device_count=8").strip()
        import jax
        jax.config.update("jax_platforms", "cpu")
    elif set(args.names) & set(LEAF_NAMES):
        ap.error("the leaf clips are the JAX package's streams only")
    for name in args.names:
        runs = ([(f"{name} mesh_pictures={m}", functools.partial(
            leaf_stream, name, m)) for m in (False, True)]
            if name in LEAF_NAMES
            else [(name, functools.partial(stream, args.package, name))])
        for label, make in runs:
            t0 = time.perf_counter()
            n, sha = digest(make())
            print(json.dumps({"name": label, "package": args.package,
                              "bytes": n, "sha256": sha,
                              "seconds": round(time.perf_counter() - t0,
                                               3)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
