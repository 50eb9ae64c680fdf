"""Adaptive QP, denoising, speed control from an RD preset, and the
checkpoint of a QPM stream in the port against the JAX package, on the
CPU.

Every stream must be byte-identical to the JAX package's and every
reconstruction equal. The QP map comes from the device helper
ctb_activity and the content classes (improve_sharpness), the
bit-rate-reduction bias, or per-CTB segment overrides; denoising runs
denoise_plane before the fused path. A checkpoint now carries the QPM's
stationary-edge context (the previous source luma), so a -sharp stream
split by checkpoint/restore equals the uninterrupted one (the JAX
package's checkpoint leaves it out, and restoring one gives None, as in
the JAX package).
"""

import pickle

import numpy as np
import pytest

from svt_hevc_tpu.config import EncoderConfig as JCfg
from svt_hevc_tpu.io.yuv import Frame as JFrame
from svt_hevc_tpu.pipeline.encoder import Encoder as JEncoder
from svt_hevc_tpu_torch import Encoder, EncoderConfig
from svt_hevc_tpu_torch.config import (SEG_DENSITY_DEBLOCK_OV,
                                       SEG_DENSITY_QP_OV, SEG_QP_OV_DELTA,
                                       SEG_QP_OV_DIRECT)
from svt_hevc_tpu_torch.io.yuv import Frame
from tests.test_torch_encoder import make_frames
from tests.test_torch_encoder import one_torch_thread  # noqa: F401
from tests.test_torch_hostpath import _stage_names, assert_same


def _planes(n, w, h, seed=4, bit_depth=8):
    """make_frames content with its top third darkened (the dark class and
    the dark-area branch act there); at 10 bits the samples times 4."""
    out = []
    for y, cb, cr in make_frames(n, w, h, seed=seed):
        y = y.copy()
        y[: h // 3] //= 4
        if bit_depth == 10:
            y, cb, cr = (p.astype(np.uint16) * 4 for p in (y, cb, cr))
        out.append((y, cb, cr))
    return out


def _cfg(w, h, **kw):
    return dict(dict(width=w, height=h, qp=32, intra_period=-1), **kw)


def _both(kw, pl, sov=None, speed=None):
    def frames(cls):
        out = [cls(*p) for p in pl]
        if sov is not None:
            for f, s in zip(out, sov):
                f.segment_ov = s
        return out

    jenc = JEncoder(JCfg(**kw))
    tenc = Encoder(EncoderConfig(**kw), device="cpu")
    if speed:
        jenc.set_speed_control(speed)
        tenc.set_speed_control(speed)
    js, jr = jenc.encode(frames(JFrame))
    ts, tr = tenc.encode(frames(Frame))
    assert_same(js, jr, ts, tr)
    return jenc, tenc


AQ_STREAMS = {
    "sharp": (_cfg(128, 64, improve_sharpness=True), 3, 8),
    "brr": (_cfg(128, 64, bit_rate_reduction=True), 3, 8),
    "sharp_10bit": (_cfg(128, 64, improve_sharpness=True, bit_depth=10),
                    3, 10),
    "sharp_tiles_slice_mode": (_cfg(128, 64, improve_sharpness=True,
                                    tile_columns=2, tile_rows=2,
                                    tile_slice_mode=1), 3, 8),
    # random access: the B pictures take the host path
    "sharp_ra_hl2": (_cfg(128, 64, improve_sharpness=True,
                          pred_structure=2, hierarchical_levels=2), 5, 8),
}


@pytest.mark.parametrize("case", list(AQ_STREAMS))
def test_adaptive_qp_stream_matches_jax(case):
    kw, n, bd = AQ_STREAMS[case]
    _both(kw, _planes(n, kw["width"], kw["height"], bit_depth=bd))


def test_segment_overrides_match_jax():
    """Direct QP, delta QP and deblock-density overrides per CTB (over the
    flat map, and over the QPM map under improve_sharpness); a frame
    without overrides in the same stream codes zero deltas. Without
    segment_ov_enabled the override is refused with JAX's ValueError."""
    sov = np.zeros((2, 4, 3), np.int32)
    sov[0, 0] = (SEG_DENSITY_QP_OV | SEG_QP_OV_DIRECT, 20, 0)
    sov[0, 1] = (SEG_DENSITY_QP_OV | SEG_QP_OV_DELTA, 6, 0)
    sov[1, 2] = (SEG_DENSITY_DEBLOCK_OV, 0, -4)
    pl = _planes(3, 128, 64, seed=7)
    for extra in ({}, dict(improve_sharpness=True)):
        _both(_cfg(128, 64, segment_ov_enabled=True, **extra), pl,
              sov=[sov, None, sov[::-1, ::-1]])
    for enc, cls in ((JEncoder(JCfg(**_cfg(128, 64))), JFrame),
                     (Encoder(EncoderConfig(**_cfg(128, 64)),
                              device="cpu"), Frame)):
        bad = cls(*pl[0])
        bad.segment_ov = sov
        with pytest.raises(ValueError, match="segment_ov_enabled"):
            enc.encode([bad])


def _noisy(n, w, h, seed):
    rng = np.random.default_rng(seed)
    out = []
    for y, cb, cr in make_frames(n, w, h, seed=seed):
        y = np.clip(y + rng.normal(0, 4.0, y.shape), 0, 255)
        out.append((y.astype(np.uint8), cb, cr))
    return out


def test_denoise_on_the_fused_path_matches_jax():
    """-denoise: the luma's noise class lets the planes through filtered
    (the source is noisy enough), then the fused device paths encode
    them."""
    import torch

    from svt_hevc_tpu_torch.gpu.analysis import denoise_plane
    pl = _noisy(3, 128, 64, seed=12)
    sig = float(denoise_plane(torch.from_numpy(pl[0][0]))[1])
    assert sig >= 0.004 * 255
    kw = _cfg(128, 64, enable_denoise=True)
    _both(kw, pl)
    _, names = _stage_names(EncoderConfig(**kw), [Frame(*p) for p in pl])
    assert names.count("pre.denoise") == 3
    assert "p.dense_md_p" in names and "p.pass1" not in names


def test_speed_control_from_m5_matches_jax():
    """Speed control toward an unreachable rate from M5: the RD host path
    first, then the dynamic preset rises into the fused presets (a host
    picture's reconstruction is the first fused P picture's reference,
    from the device DPB)."""
    jenc, tenc = _both(_cfg(128, 64, enc_mode=5), _planes(4, 128, 64),
                       speed=1e9)
    assert tenc._dyn_enc_mode == jenc._dyn_enc_mode == 9


def _static(n, seed):
    """A still background (its edges are the stationary-edge class's,
    which reads the previous source luma) with a moving bright block."""
    y0, cb, cr = _planes(1, 128, 64, seed=seed)[0]
    out = []
    for i in range(n):
        y = y0.copy()
        y[40:56, 8 + 8 * i:24 + 8 * i] = 200
        out.append((y, cb, cr))
    return out


def test_checkpoint_split_of_a_sharp_stream_equals_the_uninterrupted():
    """The split equals the uninterrupted stream (and JAX's); restored
    without prev_src_y, as from a JAX checkpoint, it would not."""
    kw = _cfg(128, 64, improve_sharpness=True)
    pl = _static(5, seed=8)
    js, _ = JEncoder(JCfg(**kw)).encode([JFrame(*p) for p in pl])
    whole, _ = Encoder(EncoderConfig(**kw), device="cpu").encode(
        [Frame(*p) for p in pl])
    assert whole == js
    e1 = Encoder(EncoderConfig(**kw), device="cpu")
    head = [au.data for au in e1.encode_pictures([Frame(*p)
                                                  for p in pl[:2]])]
    ckpt = pickle.loads(pickle.dumps(e1.checkpoint()))
    assert ckpt["prev_src_y"] is not None
    e2 = Encoder(EncoderConfig(**kw), device="cpu")
    e2.restore(ckpt)
    tail = [au.data for au in e2.encode_pictures([Frame(*p)
                                                  for p in pl[2:]])]
    assert e2.headers() + b"".join(head + tail) == whole
    del ckpt["prev_src_y"]
    e3 = Encoder(EncoderConfig(**kw), device="cpu")
    e3.restore(ckpt)
    tail = [au.data for au in e3.encode_pictures([Frame(*p)
                                                  for p in pl[2:]])]
    assert e3.headers() + b"".join(head + tail) != whole


def test_jax_checkpoint_of_a_sharp_stream_restores_into_the_port():
    """A JAX checkpoint has no prev_src_y: the port restores it with None,
    as the JAX package does, and both continue with the same bytes."""
    kw = _cfg(128, 64, improve_sharpness=True)
    pl = _static(4, seed=9)
    j1 = JEncoder(JCfg(**kw))
    list(j1.encode_pictures([JFrame(*p) for p in pl[:2]]))
    ckpt = pickle.loads(pickle.dumps(j1.checkpoint()))
    assert "prev_src_y" not in ckpt
    j2 = JEncoder(JCfg(**kw))
    j2.restore(ckpt)
    want = [au.data for au in j2.encode_pictures([JFrame(*p)
                                                  for p in pl[2:]])]
    t2 = Encoder(EncoderConfig(**kw), device="cpu")
    t2.restore(ckpt)
    assert t2._prev_src_y is None
    got = [au.data for au in t2.encode_pictures([Frame(*p)
                                                 for p in pl[2:]])]
    assert got == want
