"""10-bit (Main10) on the port's fused path against the JAX package, on
the CPU.

The upload of uint16 planes, the HME search (kernel K1's plain version)
and the M8 P- and B-picture device pipelines with their intra branch at
10-bit, the scene-cut detector on uint16 lumas, whole 10-bit streams
(IPPP at M7 and M8, random access hl=2), and a 10-bit stream resumed
from a checkpoint, whose references reach the device again through the
host planes (the device DPB does not survive a restore). Tolerance:
exact equality of every array and byte equality of every stream.
"""

import pickle

import numpy as np
import pytest

from svt_hevc_tpu.config import EncoderConfig as JCfg
from svt_hevc_tpu.io.yuv import Frame as JFrame
from svt_hevc_tpu.pipeline.encoder import Encoder as JEncoder
from svt_hevc_tpu.tpu.me import hme_search as j_hme
from svt_hevc_tpu_torch import Encoder, EncoderConfig
from svt_hevc_tpu_torch.decoder.decoder import decode_stream
from svt_hevc_tpu_torch.gpu import intra_pass
from svt_hevc_tpu_torch.gpu.me import hme_search as t_hme
from svt_hevc_tpu_torch.io.yuv import Frame
from tests.test_torch_encoder import one_torch_thread  # noqa: F401
from tests.test_torch_intra_inter import (H, W, check_fast_b_with_intra,
                                          check_fast_p_with_intra, eq,
                                          intra_frames, make_ipics)


@pytest.fixture(scope="module")
def ipics10():
    return make_ipics(10)


def test_prep_planes_and_hme_at_10_bit_match_jax(ipics10):
    """uint16 planes above 255 upload unchanged, and the HME search of
    two 10-bit pictures gives the JAX fields."""
    _, jp, tp, _, _ = ipics10
    for a, b in zip(jp, tp):
        for x, y in zip(a, b):
            eq(y, x)
    assert int(tp[0][0].max()) > 255
    mv_j, sad_j = j_hme(jp[1][0], jp[0][0])
    mv_t, sad_t = t_hme(tp[1][0], tp[0][0])
    eq(mv_t, mv_j, "hme mv")
    eq(sad_t, sad_j, "hme sad")


def test_fast_p_fused_dev_with_intra_at_10_bit_matches_jax(ipics10):
    check_fast_p_with_intra(ipics10)


def test_fast_b_fused_dev_with_intra_at_10_bit_matches_jax(ipics10):
    check_fast_b_with_intra(ipics10)


def test_scene_cut_on_10_bit_lumas_matches_jax():
    rng = np.random.default_rng(4)
    a = rng.integers(0, 1024, (64, 128)).astype(np.uint16)
    for b in (np.minimum(a + 3, 1023), 1023 - a, a // 2):
        assert (Encoder._scene_cut(a, b)
                == JEncoder._scene_cut(a, b))


STREAMS = {
    "m7_ippp_x4": (dict(enc_mode=7), 4),
    "m8_ippp_x4": (dict(enc_mode=8), 4),
    "m7_ra_hl2_x5": (dict(enc_mode=7, pred_structure=2,
                          hierarchical_levels=2), 5),
}


def _frames(n, cls):
    return [cls(y=y, cb=cb, cr=cr) for y, cb, cr in
            intra_frames(n, W, H, bit_depth=10, seed=9)]


@pytest.fixture(scope="module", params=list(STREAMS))
def streams10(request):
    kw, n = STREAMS[request.param]
    kw = dict(width=W, height=H, qp=32, intra_period=-1, bit_depth=10, **kw)
    s_j, rec_j = JEncoder(JCfg(**kw)).encode(_frames(n, JFrame))
    runs = intra_pass.WAVEFRONT["runs"]
    s_t, rec_t = Encoder(EncoderConfig(**kw), device="cpu").encode(
        _frames(n, Frame))
    return request.param, s_j, rec_j, s_t, rec_t, (
        intra_pass.WAVEFRONT["runs"] - runs)


def test_10bit_stream_byte_identical_to_jax(streams10):
    name, s_j, rec_j, s_t, rec_t, runs = streams10
    assert s_t == s_j
    for a, b in zip(rec_j, rec_t):
        for p in ("y", "cb", "cr"):
            assert getattr(b, p).dtype == np.uint16
            np.testing.assert_array_equal(getattr(a, p), getattr(b, p))
    if name.startswith("m8"):
        assert runs >= 2          # the IDR and at least one P picture


def test_10bit_stream_decodes_to_recon(streams10):
    _, _, _, s_t, rec_t, _ = streams10
    dec = decode_stream(s_t)
    assert len(dec) == len(rec_t)
    for d, r in zip(dec, rec_t):
        for p in ("y", "cb", "cr"):
            np.testing.assert_array_equal(getattr(d, p), getattr(r, p))


def test_10bit_resume_reuploads_references_at_full_depth():
    """A checkpoint cut: the restored encoder's first P picture takes its
    reference from the checkpoint's host planes, uploaded again at 16
    bits, and the stream continues as the JAX package's continuous
    encode of the same frames."""
    kw = dict(width=W, height=H, qp=30, intra_period=-1, bit_depth=10,
              enc_mode=8, scene_change_detection=False)
    full = b"".join(a.data for a in JEncoder(JCfg(**kw)).encode_pictures(
        _frames(5, JFrame)))
    fr = _frames(5, Frame)
    enc = Encoder(EncoderConfig(**kw), device="cpu")
    head = b"".join(a.data for a in enc.encode_pictures(fr[:3]))
    ck = pickle.loads(pickle.dumps(enc.checkpoint()))
    assert int(ck["ref_planes"][0].max()) > 255
    enc2 = Encoder(EncoderConfig(**kw), device="cpu")
    enc2.restore(ck)
    tail = b"".join(a.data for a in enc2.encode_pictures(fr[3:]))
    assert head + tail == full
