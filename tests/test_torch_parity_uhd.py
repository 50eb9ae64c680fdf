"""The two UHD streams that chip_smoke.py encodes on the card, encoded whole
on the CPU by the port, held to the JAX package's bytes and sha256 that
chip_smoke.py records for them (JAX_UHD); and the float32 sites at 2160p
and 4320p (tests/test_torch_float32_sites.py's UHD input set) under the
three compiles.

The configurations (make_frames is chip_smoke.make_frames):

- uhd_2160p: main's configuration (M7, qp 32, IPPP, 50 fps, 8-bit 4:2:0,
  CTB 32, DLF + SAO + TMVP + scene cut) at 3840x2160, x3 of
  make_frames(3, 3840, 2160, seed=7), through Encoder.encode_pictures;
- uhd_4320p_vbr: the command line's file (UHD_CLI_TOKENS: 8-bit M7 VBR at
  40 Mbit/s, 30 fps, the default lookahead) of make_frames(3, 7680, 4320,
  seed=7). Its lookahead batch is 4 pictures whose decimated planes
  (1080x1920) XLA reduces in two levels of windows.

Marked slow (Tier-1 runs -m 'not slow'): one stream takes minutes to
tens of minutes per package on the CPU.

    JAX_COMPILATION_CACHE_DIR= python -m pytest -m slow \
        tests/test_torch_parity_uhd.py

As a script it encodes the named configurations with one package and
prints one JSON line per stream (name, package, bytes, sha256, seconds),
which is how JAX_UHD was made:

    JAX_COMPILATION_CACHE_DIR= python tests/test_torch_parity_uhd.py \
        --package jax uhd_2160p uhd_4320p_vbr
"""

import argparse
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

NAMES = tuple(chip_smoke.JAX_UHD)


def clip(name: str) -> list:
    """The configuration's frames as (y, cb, cr) numpy planes."""
    w, h = chip_smoke.UHD_SIZES[name]
    return [(f.y, f.cb, f.cr) for f in chip_smoke.make_frames(
        chip_smoke.UHD_FRAMES, w, h, seed=7)]


def _cli_stream(package: str, planes) -> bytes:
    """The command line's output file for planes (8-bit 4:2:0 raw in)."""
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
        rc = app.main(["-i", src, "-b", out, *chip_smoke.UHD_CLI_TOKENS,
                       *extra])
        assert rc == 0
        with open(out, "rb") as f:
            return f.read()


def stream(package: str, name: str) -> bytes:
    """The whole stream of configuration name from package ("jax" or
    "port", the port on the CPU)."""
    planes = clip(name)
    if name == "uhd_4320p_vbr":
        return _cli_stream(package, planes)
    if package == "jax":
        from svt_hevc_tpu.config import EncoderConfig
        from svt_hevc_tpu.io.yuv import Frame
        from svt_hevc_tpu.pipeline.encoder import Encoder
        enc = Encoder(EncoderConfig(**chip_smoke.uhd_config_kw(name)))
    else:
        from svt_hevc_tpu_torch import Encoder, EncoderConfig
        from svt_hevc_tpu_torch.io.yuv import Frame
        enc = Encoder(EncoderConfig(**chip_smoke.uhd_config_kw(name)),
                      device="cpu")
    frames = [Frame(y=y, cb=cb, cr=cr) for y, cb, cr in planes]
    aus = [a.data for a in enc.encode_pictures(iter(frames))]
    assert len(aus) == len(frames)
    return enc.headers() + b"".join(aus)


def digest(s: bytes) -> tuple:
    return len(s), hashlib.sha256(s).hexdigest()


@pytest.mark.slow
@pytest.mark.parametrize("name", NAMES)
def test_uhd_port_stream_equals_the_recorded_jax_stream(name):
    import torch
    torch.set_num_threads(min(4, os.cpu_count() or 1))
    assert digest(stream("port", name)) == chip_smoke.JAX_UHD[name]


@pytest.mark.slow
@pytest.mark.parametrize("isa", ["default", "avx2", "sse4_2"])
def test_uhd_float32_sites_under_each_compile(isa):
    """Every float32 site on the 2160p and 4320p inputs (UHD_GROUP): a
    state-1 value equals the JAX value under this compile; a state-2
    value is the exact value rounded once and the JAX value lies within
    its spread; a state-3 value (the 2160p lookahead SADs) is the
    reference compile's recorded value (UHD_LA_RECORDS) and its model,
    and the JAX value one of the models."""
    from tests import test_torch_float32_sites as fs
    jv = fs.jax_values(isa, fs.UHD_GROUP)
    port = fs.port_site_values(fs.UHD_GROUP)
    exact = fs.exact_site_values(fs.UHD_GROUP)
    assert set(jv) == set(port)
    for k, v in jv.items():
        state = fs.state_of(k)
        if state == 1:
            np.testing.assert_array_equal(port[k], v, err_msg=k)
        elif state == 3:
            np.testing.assert_array_equal(
                port[k].view(np.uint32),
                np.array(fs.UHD_LA_RECORDS[k], np.uint32), err_msg=k)
            models = fs.la_sad_models(k)
            np.testing.assert_array_equal(port[k], models["reference"],
                                          err_msg=k)
            assert any(np.array_equal(v, m) for m in models.values()), k
        else:
            np.testing.assert_array_equal(port[k], exact[k], err_msg=k)
            assert fs.jax_within_spread(v, exact[k], isa, k), (isa, k)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--package", choices=["jax", "port"], required=True)
    ap.add_argument("names", nargs="+", choices=NAMES)
    args = ap.parse_args(argv)
    if args.package == "jax":
        os.environ.setdefault("JAX_PLATFORMS", "cpu")
        import jax
        jax.config.update("jax_platforms", "cpu")
    for name in args.names:
        t0 = time.perf_counter()
        n, sha = digest(stream(args.package, name))
        print(json.dumps({"name": name, "package": args.package,
                          "bytes": n, "sha256": sha,
                          "seconds": round(time.perf_counter() - t0, 3)}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
