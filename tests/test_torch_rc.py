"""Rate control and speed control in the port against the JAX package,
on the CPU.

lookahead_stats (the lookahead's batched statistics) on the same lumas:
zz_sad, gm_sad, gm_mv and the histograms exactly equal, the variance
within a relative 1e-6 (the JAX graph sums float32 squares in its own
order, the port in float64 and rounds once). The lookahead complexities
the rate control reads, then whole VBR streams (lookahead 8, reactive
with no lookahead, hierarchical low-delay P under a strict-CBR VBV with
filler data), a qp-file stream, and speed control (the dynamic preset
rising through M8-M9 to M11, or held at the configured preset): byte
equality of every stream, which holds the QP sequences equal.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from svt_hevc_tpu.config import EncoderConfig as JCfg
from svt_hevc_tpu.io.yuv import Frame as JFrame
from svt_hevc_tpu.pipeline.encoder import Encoder as JEncoder
from svt_hevc_tpu.tpu.analysis import lookahead_stats as j_la
from svt_hevc_tpu_torch import Encoder, EncoderConfig
from svt_hevc_tpu_torch.decoder.decoder import decode_stream
from svt_hevc_tpu_torch.gpu.analysis import lookahead_stats as t_la
from svt_hevc_tpu_torch.io.yuv import Frame
from tests.test_torch_encoder import one_torch_thread  # noqa: F401
from tests.test_torch_intra_inter import H, W, intra_frames


def _lumas(bd, t, h, w, seed):
    """t lumas of a texture panning (3, -2) pixels a picture, with noise."""
    rng = np.random.default_rng(seed)
    hi = 1 << bd
    base = rng.integers(0, hi, (h + 40, w + 40))
    ys = [np.roll(np.roll(base, 3 * i, 0), -2 * i, 1)[:h, :w]
          + rng.integers(0, 5, (h, w)) for i in range(t)]
    return np.clip(np.stack(ys), 0, hi - 1).astype(np.int32)


@pytest.mark.parametrize("bd,t,h,w", [(8, 6, 64, 128), (10, 5, 128, 256),
                                      (8, 2, 32, 48)])
def test_lookahead_stats_matches_jax(bd, t, h, w):
    ys = _lumas(bd, t, h, w, seed=bd + t)
    want = j_la(jnp.asarray(ys))
    got = t_la(torch.from_numpy(ys))
    for k in ("zz_sad", "gm_sad", "gm_mv", "hist"):
        assert got[k].dtype == getattr(torch, str(np.asarray(want[k]).dtype))
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
    np.testing.assert_allclose(got["variance"].numpy(),
                               np.asarray(want["variance"]), rtol=1e-6)
    assert got["gm_mv"].shape == (t - 1, 2)


def test_la_complexities_match_jax():
    ys = list(_lumas(8, 7, 64, 128, seed=3))
    enc = Encoder(EncoderConfig(width=128, height=64), device="cpu")
    for prev in (None, ys[0]):
        got = enc._la_complexities(ys[1:], prev)
        want = JEncoder._la_complexities(ys[1:], prev)
        assert got[1:] == want[1:]
        np.testing.assert_allclose(got[0], want[0], rtol=1e-6)


STREAMS = {
    # the lookahead high-level RC over windows of 9 complexities
    "vbr_la8_x10": (dict(rate_control_mode=1, target_bitrate=200_000,
                         look_ahead_distance=8), 10),
    # the reactive VBR model (no lookahead)
    "vbr_la0_x6": (dict(rate_control_mode=1, target_bitrate=150_000,
                        look_ahead_distance=0), 6),
    # hierarchical low-delay P with per-layer rate models, strict CBR
    # (maxrate == target) so filler data pads the access units
    "cbr_hier2_filler_x8": (dict(rate_control_mode=1,
                                 target_bitrate=400_000,
                                 vbv_maxrate=400_000, vbv_bufsize=200_000,
                                 hierarchical_levels=2,
                                 look_ahead_distance=4), 8),
}


def _frames(n, cls):
    return [cls(y=y, cb=cb, cr=cr)
            for y, cb, cr in intra_frames(n, W, H, seed=5)]


def _kw(extra):
    return dict(dict(width=W, height=H, qp=32, intra_period=-1, fps_num=25,
                     enc_mode=8), **extra)


@pytest.fixture(scope="module", params=list(STREAMS))
def rc_streams(request):
    kw, n = STREAMS[request.param]
    je = JEncoder(JCfg(**_kw(kw)))
    aus_j = list(je.encode_pictures(_frames(n, JFrame)))
    te = Encoder(EncoderConfig(**_kw(kw)), device="cpu")
    aus_t = list(te.encode_pictures(_frames(n, Frame)))
    return request.param, je, aus_j, te, aus_t


def test_rc_stream_byte_identical_to_jax(rc_streams):
    name, je, aus_j, te, aus_t = rc_streams
    assert [a.data for a in aus_t] == [a.data for a in aus_j]
    assert te.last_rc.qp == je.last_rc.qp
    gt, gj = te.last_rc._gain, je.last_rc._gain
    assert gt.keys() == gj.keys()
    for k in gj:
        if k == (True, 0):
            # calibrated on the first picture, whose complexity is the
            # variance proxy (the variance's tolerance above)
            assert gt[k] == pytest.approx(gj[k], rel=1e-5)
        else:
            assert gt[k] == gj[k], k
    if name.startswith("cbr"):
        assert any(b"\x00\x00\x01\x4c" in a.data for a in aus_t), \
            "no filler data NAL"


def test_rc_stream_decodes_to_recon(rc_streams):
    _, _, _, te, aus_t = rc_streams
    s = te.headers() + b"".join(a.data for a in aus_t)
    dec = decode_stream(s)
    assert len(dec) == len(aus_t)
    for d, a in zip(dec, aus_t):
        np.testing.assert_array_equal(d.y, a.recon.y)


def test_qp_file_stream_matches_jax():
    qps = [24, 38, 30, 27]
    kw = _kw(dict(enc_mode=7))
    s_j, _ = JEncoder(JCfg(**kw)).encode(_frames(4, JFrame), frame_qps=qps)
    s_t, rec = Encoder(EncoderConfig(**kw), device="cpu").encode(
        _frames(4, Frame), frame_qps=qps)
    assert s_t == s_j
    for d, r in zip(decode_stream(s_t), rec):
        np.testing.assert_array_equal(d.y, r.y)


@pytest.mark.parametrize("target,final", [(1e9, 11), (1e-9, 7)])
def test_speed_control_matches_jax(target, final):
    """An unreachable target raises the dynamic preset by one after
    every picture (M7, M8, M9, M10, M11: the P pictures at M8-M9 carry
    intra CUs); a trivially met one holds it at the configured M7."""
    kw = _kw(dict(enc_mode=7))
    je = JEncoder(JCfg(**kw))
    je.set_speed_control(target)
    te = Encoder(EncoderConfig(**kw), device="cpu")
    te.set_speed_control(target)
    s_j = [a.data for a in je.encode_pictures(_frames(6, JFrame))]
    s_t = [a.data for a in te.encode_pictures(_frames(6, Frame))]
    assert s_t == s_j
    assert te._dyn_enc_mode == je._dyn_enc_mode == final
