"""The port's command line (svt_hevc_tpu_torch.app) and streaming API
(svt_hevc_tpu_torch.api.EncoderHandle) against the JAX package's, on
the CPU (-device cpu / device="cpu").

Every JAX CLI token exists in the port with the same destination,
default, type and choices (the port adds -device); the CLI's streams and
recon files equal the JAX CLI's for the default all-intra run, the
10-bit M8 VBR run, two channels, and a stdin-to-stdout pipe; the
handle's packets equal the JAX handle's and the batch encode; failures
surface with their error codes. Tolerance: byte equality.
"""

import io
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from svt_hevc_tpu import app as japp
from svt_hevc_tpu import EncoderConfig as JCfg
from svt_hevc_tpu import EncoderHandle as JHandle
from svt_hevc_tpu.io.yuv import Frame as JFrame
from svt_hevc_tpu_torch import Encoder, EncoderConfig, EncoderHandle
from svt_hevc_tpu_torch import app as tapp
from svt_hevc_tpu_torch.decoder.decoder import decode_stream
from svt_hevc_tpu_torch.errors import EncoderError, ErrorCode
from svt_hevc_tpu_torch.io.yuv import Frame, read_yuv, write_yuv420
from tests.test_torch_encoder import one_torch_thread  # noqa: F401
from tests.test_torch_intra_inter import H, W, intra_frames

ROOT = Path(__file__).resolve().parents[1]


def _actions(parser):
    return {a.dest: a for a in parser._actions if a.dest != "help"}


def test_cli_tokens_and_defaults_match_jax():
    j = _actions(japp.build_parser())
    t = _actions(tapp.build_parser())
    assert set(t) - set(j) == {"device"}
    for dest, a in j.items():
        b = t[dest]
        assert b.option_strings == a.option_strings, dest
        assert (b.default, b.type, b.choices, b.required) == \
            (a.default, a.type, a.choices, a.required), dest
        assert type(b) is type(a), dest
    assert t["device"].default == "cuda"
    assert t["intra_period"].default == 0          # all intra


def _write(tmp_path, name, n, bit_depth=8, seed=3):
    frames = [Frame(y=y, cb=cb, cr=cr) for y, cb, cr in
              intra_frames(n, W, H, bit_depth=bit_depth, seed=seed)]
    path = tmp_path / name
    write_yuv420(str(path), frames)
    return path


def _both(tmp_path, args, outs):
    """Run both CLIs in this process with the same tokens; the port's
    outputs go to files prefixed t_, the JAX package's to j_."""
    def sub(prefix):
        return [str(tmp_path / (prefix + a)) if a in outs else a
                for a in args]
    assert japp.main(sub("j_")) == 0
    assert tapp.main(sub("t_") + ["-device", "cpu"]) == 0
    return {o: ((tmp_path / ("j_" + o)).read_bytes(),
                (tmp_path / ("t_" + o)).read_bytes()) for o in outs}


def test_cli_roundtrip_matches_jax(tmp_path):
    """Default tokens (all intra at qp 32) with a recon file."""
    yuv = _write(tmp_path, "in.yuv", 3)
    got = _both(tmp_path, ["-i", str(yuv), "-w", str(W), "-h", str(H),
                           "-b", "out.265", "-o", "rec.yuv", "-fps", "30"],
                {"out.265", "rec.yuv"})
    (sj, st), (rj, rt) = got["out.265"], got["rec.yuv"]
    assert st == sj and rt == rj
    dec = decode_stream(st)
    recons = list(read_yuv(str(tmp_path / "t_rec.yuv"), W, H))
    assert len(dec) == len(recons) == 3
    for d, r in zip(dec, recons):
        np.testing.assert_array_equal(d.y, r.y)


def test_cli_10bit_m8_vbr_matches_jax(tmp_path):
    """The slice's target tokens at a test size: 10-bit, M8 (intra CUs in
    P pictures), one IDR, VBR with the default lookahead."""
    yuv = _write(tmp_path, "in10.yuv", 5, bit_depth=10)
    got = _both(tmp_path, ["-i", str(yuv), "-w", str(W), "-h", str(H),
                           "-bit-depth", "10", "-encMode", "8",
                           "-intra-period", "-1", "-rc", "1",
                           "-tbr", "300000", "-fps", "25",
                           "-b", "out.265", "-o", "rec.yuv"],
                {"out.265", "rec.yuv"})
    (sj, st), (rj, rt) = got["out.265"], got["rec.yuv"]
    assert st == sj and rt == rj
    dec = decode_stream(st)
    recons = list(read_yuv(str(tmp_path / "t_rec.yuv"), W, H,
                           bit_depth=10))
    for d, r in zip(dec, recons):
        np.testing.assert_array_equal(d.y, r.y)


def test_cli_multichannel_matches_jax(tmp_path, capsys):
    a = _write(tmp_path, "a.yuv", 2, seed=1)
    b = _write(tmp_path, "b.yuv", 2, seed=2)
    got = _both(tmp_path, ["-i", str(a), "-b", "a.265", "-i", str(b),
                           "-b", "b.265", "-w", str(W), "-h", str(H),
                           "-q", "35", "-intra-period", "-1"],
                {"a.265", "b.265"})
    for sj, st in got.values():
        assert st == sj
        assert len(decode_stream(st)) == 2
    assert "multi-channel: 2 channels" in capsys.readouterr().out


def test_cli_pipe_stdin_stdout_matches_jax(tmp_path):
    """Raw YUV on stdin, Annex-B on stdout, the log on stderr."""
    yuv = _write(tmp_path, "in.yuv", 2)
    assert japp.main(["-i", str(yuv), "-w", str(W), "-h", str(H), "-q",
                      "34", "-intra-period", "-1", "-b",
                      str(tmp_path / "j.265")]) == 0
    r = subprocess.run(
        [sys.executable, "-m", "svt_hevc_tpu_torch.app", "-i", "-",
         "-w", str(W), "-h", str(H), "-q", "34", "-intra-period", "-1",
         "-b", "-", "-device", "cpu"],
        input=yuv.read_bytes(), capture_output=True, cwd=ROOT,
        timeout=300)
    assert r.returncode == 0, r.stderr.decode()[-800:]
    assert r.stdout == (tmp_path / "j.265").read_bytes()
    assert b"encoded 2 frames" in r.stderr


def test_cli_runs_on_the_card_unless_asked_for_the_cpu(tmp_path):
    yuv = _write(tmp_path, "in.yuv", 1)
    args = ["-i", str(yuv), "-w", str(W), "-h", str(H), "-b",
            str(tmp_path / "o.265")]
    assert tapp.build_parser().parse_args(args).device == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            tapp.main(args)
    # -rd 1 and the RD presets take the host path, on the CPU as asked,
    # with the JAX CLI's bytes
    for extra in (["-rd", "1"], ["-encMode", "3"]):
        got = _both(tmp_path, args[:-1] + ["o.265"] + extra, ["o.265"])
        assert got["o.265"][1] == got["o.265"][0], extra


# ------------------------------------------------------------ the handle

def _stream_through(handle, frames):
    out = [handle.stream_header()]
    for f in frames:
        handle.send_picture(f)
    handle.send_eos()
    pkts = list(handle.packets())
    handle.close()
    return out, pkts


@pytest.mark.parametrize("kw,n", [
    (dict(intra_period=-1, enc_mode=8), 4),
    (dict(intra_period=-1, pred_structure=2, hierarchical_levels=2), 5),
], ids=["m8_ippp", "ra_hl2"])
def test_handle_matches_jax_handle_and_batch(kw, n):
    kw = dict(width=W, height=H, qp=33, **kw)
    planes = intra_frames(n, W, H, seed=4)
    hdr_j, pk_j = _stream_through(JHandle(JCfg(**kw)),
                                  [JFrame(*p) for p in planes])
    hdr_t, pk_t = _stream_through(
        EncoderHandle(EncoderConfig(**kw), device="cpu",
                      return_recon=True), [Frame(*p) for p in planes])
    assert hdr_t == hdr_j
    assert [(p.data, p.pts, p.dts, p.slice_type, p.is_idr) for p in pk_t] \
        == [(p.data, p.pts, p.dts, p.slice_type, p.is_idr) for p in pk_j]
    batch, _ = Encoder(EncoderConfig(**kw), device="cpu").encode(
        [Frame(*p) for p in planes])
    assert b"".join(hdr_t + [p.data for p in pk_t]) == batch
    by_pts = {p.pts: p for p in pk_t}
    for i, d in enumerate(decode_stream(batch)):
        np.testing.assert_array_equal(d.y, by_pts[i].recon.y)


def test_handle_error_surface():
    cfg = EncoderConfig(width=W, height=H, qp=33, intra_period=-1)
    h = EncoderHandle(cfg, device="cpu")
    big = Frame(*intra_frames(1, 2 * W, 2 * H)[0])
    with pytest.raises(EncoderError) as e:
        h.send_picture(big)
    assert e.value.code == ErrorCode.INPUT_FORMAT
    h.close()
    # a failure inside the worker reaches the caller with its code and
    # through the error callback
    h = EncoderHandle(cfg, device="cpu")
    seen = []
    h.set_error_callback(lambda code, exc: seen.append(code))
    bad = Frame(*intra_frames(1, W, H)[0])
    # segment overrides without segment_ov_enabled: JAX's ValueError
    bad.segment_ov = np.zeros((2, 4, 3), np.int32)
    h.send_picture(bad)
    h.send_eos()
    with pytest.raises(ValueError):
        list(h.packets())
    assert h.error_code == ErrorCode.BAD_PARAMETER
    assert seen == [ErrorCode.BAD_PARAMETER]
    h.close()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            EncoderHandle(cfg)
    with pytest.raises(NotImplementedError):
        EncoderHandle(EncoderConfig(width=W, height=H, mesh_pictures=True),
                      device="cpu")


def test_read_yuv_pipe_of_10_bit_samples():
    """The raw reader the CLI feeds from a pipe keeps 10-bit samples."""
    frames = [Frame(*p) for p in intra_frames(2, W, H, bit_depth=10)]
    buf = io.BytesIO()
    write_yuv420(buf, frames)
    buf.seek(0)
    back = list(read_yuv(buf, W, H, bit_depth=10))
    for a, b in zip(frames, back):
        np.testing.assert_array_equal(a.y, b.y)
