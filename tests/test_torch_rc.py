"""Rate control and speed control in the port against the JAX package,
on the CPU.

lookahead_stats (the lookahead's batched statistics) on the same lumas:
zz_sad, gm_sad, gm_mv and the histograms exactly equal. The variance is
host-dependent in the reference (tests/test_torch_float32_sites.py): the
JAX graph's float32 sum of squares follows the compiling host's vector
ISA. The port's variance equals the exact variance rounded once, bit for
bit, and the JAX variance under each of three compiles lies within its
measured spread of it (a few float32 ulps). The lookahead complexities
the rate control reads (the first picture's is the variance proxy
sqrt(variance) / 4, and calibrates the IDR's rate-model gain), then
whole VBR streams (lookahead 8, reactive with no lookahead, hierarchical
low-delay P under a strict-CBR VBV with filler data), a qp-file stream,
and speed control (the dynamic preset rising through M8-M9 to M11, or
held at the configured preset): byte equality of every stream, which
holds the QP sequences equal.
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
from tests.test_torch_float32_sites import (WIDE_LA, assert_host_dependent,
                                            np_variance, vbr_first_batch,
                                            wide_la_lumas)
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
    for k in ("zz_sad", "gm_sad", "gm_mv", "hist", "variance"):
        assert got[k].dtype == getattr(torch, str(np.asarray(want[k]).dtype))
    for k in ("zz_sad", "gm_sad", "gm_mv", "hist"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
    key = f"rc_{bd}_{t}_{h}x{w}"
    assert_host_dependent(f"la/{key}/variance", "rc",
                          got["variance"].numpy(), np_variance(ys)[1:])
    assert got["gm_mv"].shape == (t - 1, 2)


@pytest.mark.parametrize("cut", [False, True])
@pytest.mark.parametrize("bd", [8, 10])
@pytest.mark.parametrize("h,w", WIDE_LA)
def test_lookahead_sads_of_wide_and_tall_lumas_match_jax(h, w, bd, cut):
    """zz_sad and gm_sad where XLA reduces the SADs' grid of window sums in
    two levels (a luma axis past 4096: 9 x 33, 33 x 9 and 1 x 64 windows)
    or over row lanes (480x720's 4 x 6), past 2^24 sixteenths: equal to
    JAX. These grids' order is the same under the default, AVX2 and
    SSE4_2 compiles (tests/test_torch_float32_sites.py holds each)."""
    ys = wide_la_lumas(h, w, bd, cut)
    want = j_la(jnp.asarray(ys))
    got = t_la(torch.from_numpy(ys))
    for k in ("zz_sad", "gm_sad", "gm_mv", "hist"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)


def _idr_complexity(var) -> float:
    """Encoder._la_complexities' proxy for a picture with no predecessor."""
    return max(float(np.sqrt(float(var))) / 4.0, 1e-3)


def test_la_complexities_match_jax():
    ys = list(_lumas(8, 7, 64, 128, seed=3))
    enc = Encoder(EncoderConfig(width=128, height=64), device="cpu")
    got = enc._la_complexities(ys[1:], ys[0])
    assert got == JEncoder._la_complexities(ys[1:], ys[0])
    got = enc._la_complexities(ys[1:], None)
    want = JEncoder._la_complexities(ys[1:], None)
    assert got[1:] == want[1:]
    # the first picture's: the variance proxy, from the exact variance
    stack = np.stack([ys[1]] + ys[1:])
    exact = np_variance(stack)[1:]
    assert got[0] == _idr_complexity(exact[0])
    port = t_la(torch.from_numpy(stack))["variance"].numpy()
    assert_host_dependent("la/rc_complexities/variance", "rc", port, exact)


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


def _recording_idr_updates(rc_cls, log):
    """rc_cls.update_lookahead, recording (coded bits, QP, complexity) of
    every IDR update into log."""
    update = rc_cls.update_lookahead

    def recorded(self, coded_bits, used_qp, cplx, is_idr=False, layer=0):
        if is_idr:
            log.append((coded_bits, used_qp, cplx))
        return update(self, coded_bits, used_qp, cplx, is_idr=is_idr,
                      layer=layer)
    return update, recorded


@pytest.fixture(scope="module", params=list(STREAMS))
def rc_streams(request):
    from svt_hevc_tpu.pipeline.rate_control import RateControl as JRC
    from svt_hevc_tpu_torch.pipeline.rate_control import RateControl as TRC
    kw, n = STREAMS[request.param]
    idr = {"jax": [], "port": []}
    patched = [(cls, *_recording_idr_updates(cls, idr[who]))
               for cls, who in ((JRC, "jax"), (TRC, "port"))]
    try:
        for cls, _, recorded in patched:
            cls.update_lookahead = recorded
        je = JEncoder(JCfg(**_kw(kw)))
        aus_j = list(je.encode_pictures(_frames(n, JFrame)))
        te = Encoder(EncoderConfig(**_kw(kw)), device="cpu")
        aus_t = list(te.encode_pictures(_frames(n, Frame)))
    finally:
        for cls, update, _ in patched:
            cls.update_lookahead = update
    return request.param, je, aus_j, te, aus_t, idr


def test_rc_stream_byte_identical_to_jax(rc_streams):
    name, je, aus_j, te, aus_t, idr = rc_streams
    assert [a.data for a in aus_t] == [a.data for a in aus_j]
    assert te.last_rc.qp == je.last_rc.qp
    gt, gj = te.last_rc._gain, je.last_rc._gain
    assert gt.keys() == gj.keys()
    for k in gj:
        if k == (True, 0):
            # calibrated on the IDR's complexity, the variance proxy:
            # the port's from the exact variance rounded once, the JAX
            # package's from a variance within its measured spread
            key = f"rc_{name}"
            stack = vbr_first_batch(name)
            exact = np_variance(stack)[1:]
            [(bits, qp, cplx)] = idr["port"]
            assert [(bits, qp)] == [u[:2] for u in idr["jax"]]
            assert cplx == _idr_complexity(exact[0])
            assert gt[k] == bits * 2.0 ** (qp / 6.0) / cplx
            port = t_la(torch.from_numpy(stack))["variance"].numpy()
            assert_host_dependent(f"la/{key}/variance", "rc", port, exact)
        else:
            assert gt[k] == gj[k], k
    if name.startswith("cbr"):
        assert any(b"\x00\x00\x01\x4c" in a.data for a in aus_t), \
            "no filler data NAL"


def test_rc_stream_decodes_to_recon(rc_streams):
    _, _, _, te, aus_t, _ = rc_streams
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
