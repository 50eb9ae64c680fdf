"""The port's host path against the JAX package, on the CPU.

Configurations the fused device paths do not take (tiles, motion-
constrained tile sets, one slice per tile, 4:2:2 and 4:4:4, odd
dimensions, constrained intra, the RD presets M0-M5, the rd /
split_policy keywords) go through the numpy CTU coder fed by the device
helpers (dev_me_field on kernel K1's plain version here, the open-loop
intra search maps). Every stream must be byte-identical to the JAX
package's and every reconstruction equal; the port's decoder must give
back the reconstruction.
"""

import contextlib

import numpy as np
import pytest

from svt_hevc_tpu.config import EncoderConfig as JCfg
from svt_hevc_tpu.io.yuv import Frame as JFrame
from svt_hevc_tpu.pipeline.encoder import Encoder as JEncoder
from svt_hevc_tpu_torch import Encoder, EncoderConfig
from svt_hevc_tpu_torch.decoder.decoder import decode_stream
from svt_hevc_tpu_torch.io.yuv import Frame
from tests.test_torch_encoder import make_frames
from tests.test_torch_encoder import one_torch_thread  # noqa: F401


def planes(n, w, h, seed=5, chroma_format=1):
    """make_frames content; 4:2:2 / 4:4:4 chroma repeats the 4:2:0 rows
    (and columns)."""
    out = []
    for y, cb, cr in make_frames(n, w, h, seed=seed):
        if chroma_format >= 2:
            cb, cr = np.repeat(cb, 2, 0), np.repeat(cr, 2, 0)
        if chroma_format == 3:
            cb, cr = np.repeat(cb, 2, 1), np.repeat(cr, 2, 1)
        out.append((y, cb, cr))
    return out


def encode_both(w, h, pl, kw, rd=None):
    """(JAX stream, JAX recons, port stream, port recons), qp 32 IPPP
    unless kw says otherwise."""
    kw = dict(dict(width=w, height=h, qp=32, intra_period=-1), **kw)
    js, jr = JEncoder(JCfg(**kw)).encode([JFrame(*p) for p in pl], rd=rd)
    enc = Encoder(EncoderConfig(**kw), device="cpu")
    ts, tr = enc.encode([Frame(*p) for p in pl], rd=rd)
    return js, jr, ts, tr


def assert_same(js, jr, ts, tr):
    assert ts == js
    assert len(tr) == len(jr)
    for a, b in zip(tr, jr):
        for c in ("y", "cb", "cr"):
            got, want = getattr(a, c), getattr(b, c)
            assert got.dtype == want.dtype and got.shape == want.shape
            np.testing.assert_array_equal(got, want, err_msg=c)
    dec = decode_stream(ts)
    assert len(dec) == len(tr)
    for d, r in zip(dec, tr):
        np.testing.assert_array_equal(d.y, r.y)
        np.testing.assert_array_equal(d.cb, r.cb)


STREAMS = {
    # (w, h, frames, chroma_format, config, rd)
    "tiles_2x1": (96, 64, 3, 1, dict(tile_columns=2), None),
    "tiles_1x2": (96, 64, 3, 1, dict(tile_rows=2), None),
    "tiles_2x2": (96, 64, 3, 1, dict(tile_columns=2, tile_rows=2), None),
    "tiles_2x2_ctb64": (128, 128, 2, 1, dict(tile_columns=2, tile_rows=2,
                                             ctb_size=64), None),
    "tile_slice_mode_2x2": (128, 64, 3, 1, dict(tile_columns=2,
                                                tile_rows=2,
                                                tile_slice_mode=1), None),
    "c422_ippp": (64, 64, 3, 2, {}, None),
    "c444_ippp": (64, 64, 3, 3, {}, None),
    "c422_ra_hl2": (64, 64, 3, 2, dict(pred_structure=2,
                                       hierarchical_levels=2), None),
    "c444_ra_hl2": (64, 64, 3, 3, dict(pred_structure=2,
                                       hierarchical_levels=2), None),
    "odd_72x68_422": (72, 68, 3, 2, {}, None),
    "m0": (64, 64, 2, 1, dict(enc_mode=0), None),
    "m3": (64, 64, 2, 1, dict(enc_mode=3), None),
    "m5": (128, 64, 3, 1, dict(enc_mode=5), None),
    "m7_rd_keyword": (64, 64, 2, 1, {}, True),
}


@pytest.mark.parametrize("case", list(STREAMS))
def test_host_path_stream_matches_jax(case):
    w, h, n, cf, kw, rd = STREAMS[case]
    pl = planes(n, w, h, chroma_format=cf)
    js, jr, ts, tr = encode_both(w, h, pl, dict(kw, chroma_format=cf), rd)
    assert_same(js, jr, ts, tr)


def test_split_policy_keyword_matches_jax():
    """encode_frame's test policies of the CTU coder (a forced quadtree
    split and NxN partitions) take the host path on both sides."""
    pl = planes(1, 64, 64, seed=3)[0]
    cfg = dict(width=64, height=64, qp=30)

    def split(x, y, log2, depth):
        return log2 > 4

    def nxn(x, y):
        return (x // 8 + y // 8) % 2 == 0

    jenc = JEncoder(JCfg(**cfg))
    tenc = Encoder(EncoderConfig(**cfg), device="cpu")
    jp = jenc.encode_frame(JFrame(*pl), split_policy=split,
                           part_nxn_policy=nxn)
    tp = tenc.encode_frame(Frame(*pl), split_policy=split,
                           part_nxn_policy=nxn)
    assert tp.nal_bytes == jp.nal_bytes
    np.testing.assert_array_equal(tp.recon.y, jp.recon.y)
    dec = decode_stream(tenc.headers() + tp.nal_bytes)
    np.testing.assert_array_equal(dec[0].y, tp.recon.y)


def test_mcts_matches_jax_and_keeps_motion_in_its_tile(monkeypatch):
    """Motion-constrained tile sets: the stream equals JAX's, carries the
    MCTS SEI, and every MC window the port's decoder reads stays inside
    the tile of the block."""
    import svt_hevc_tpu_torch.core.inter as inter_mod
    from svt_hevc_tpu_torch.bitstream import sei as sei_mod
    from svt_hevc_tpu_torch.bitstream.nal import NalUnitType, split_annexb

    pl = planes(4, 128, 64, seed=91)
    js, jr, ts, tr = encode_both(128, 64, pl, dict(
        tile_columns=2, constrained_motion_tiles=True,
        scene_change_detection=False))
    assert_same(js, jr, ts, tr)
    types = [m.payload_type for t, e in split_annexb(ts)
             if t == NalUnitType.PREFIX_SEI_NUT
             for m in sei_mod.parse_sei_rbsp(bytes(e))]
    assert sei_mod.SEI_TEMPORAL_MCTS in types

    calls = []
    real_luma, real_raw = inter_mod.interp_luma, inter_mod.interp_luma_raw

    def spy_luma(ref, x0, y0, nw, nh, mvx, mvy, bit_depth=8):
        calls.append((x0, y0, nw, nh, mvx, mvy))
        return real_luma(ref, x0, y0, nw, nh, mvx, mvy, bit_depth)

    def spy_raw(ref, x0, y0, nw, nh, mvx, mvy, bit_depth=8):
        calls.append((x0, y0, nw, nh, mvx, mvy))
        return real_raw(ref, x0, y0, nw, nh, mvx, mvy, bit_depth)

    monkeypatch.setattr(inter_mod, "interp_luma", spy_luma)
    monkeypatch.setattr(inter_mod, "interp_luma_raw", spy_raw)
    decode_stream(ts)
    assert calls, "no inter prediction in the decoded stream"
    for x0, y0, nw, nh, mvx, mvy in calls:
        tx0, tx1 = (0, 64) if x0 < 64 else (64, 128)
        ix, fx = x0 + (mvx >> 2), mvx & 3
        iy, fy = y0 + (mvy >> 2), mvy & 3
        assert ix - (3 if fx else 0) >= tx0, (x0, mvx)
        assert ix + nw + (4 if fx else 0) <= tx1, (x0, nw, mvx)
        assert iy - (3 if fy else 0) >= 0, (y0, mvy)
        assert iy + nh + (4 if fy else 0) <= 64, (y0, nh, mvy)


class _Names:
    def __init__(self):
        self.names = []

    @contextlib.contextmanager
    def stage(self, name):
        self.names.append(name)
        yield


def _stage_names(cfg, frames):
    import svt_hevc_tpu_torch.gpu.encode as genc
    rec = _Names()
    genc.STAGE_TIMER = rec
    try:
        stream, _ = Encoder(cfg, device="cpu").encode(frames)
    finally:
        genc.STAGE_TIMER = None
    return stream, rec.names


def test_constrained_intra_mixes_the_fused_i_and_host_p_paths():
    """Constrained intra: the I picture takes the fused device path, the
    P pictures the host path (motion seed from the device HME, OIS maps
    from the uploaded plane); the pipelined I picture is finished before
    the first host-path picture's pass 1 (its motion is the TMVP
    source), and a host-path picture's reconstruction is uploaded into
    the device DPB; the stream equals JAX's."""
    pl = planes(3, 128, 64, seed=6)
    js, jr, ts, tr = encode_both(128, 64, pl, dict(constrained_intra=True))
    assert_same(js, jr, ts, tr)
    cfg = EncoderConfig(width=128, height=64, qp=32, intra_period=-1,
                        constrained_intra=True)
    stream, names = _stage_names(cfg, [Frame(*p) for p in pl])
    assert stream == ts
    i_part = names[:names.index("i._finish_fused") + 1]
    assert "i.intra_wavefront_pass" in i_part
    p_front = ["p.upload", "p.hme_search", "p.ois_maps"]
    p_host = ["p.pass1", "p.dlf_sao", "p.pass2", "p.cabac", "p.dpb_upload"]
    assert names[len(i_part):] == (p_front + ["i.download", "i.host_emit"]
                                   + p_host + p_front + p_host)


def test_host_path_stages_with_tiles():
    """With tiles no picture has a device context: the motion seed comes
    from dev_me_field and the OIS maps from a host plane."""
    pl = planes(2, 96, 64)
    cfg = EncoderConfig(width=96, height=64, qp=32, intra_period=-1,
                        tile_columns=2)
    _, names = _stage_names(cfg, [Frame(*p) for p in pl])
    assert names == (["i.ois_maps", "i.pass1", "i.dlf_sao", "i.pass2",
                      "i.cabac", "p.dev_me_field", "p.ois_maps", "p.pass1",
                      "p.dlf_sao", "p.pass2", "p.cabac"])


@pytest.mark.parametrize("kw", [
    dict(constrained_intra=True), dict(pred_structure=2, enc_mode=5),
    dict(tile_columns=2), dict(enc_mode=4), dict(enc_mode=0),
    dict(tile_rows=2), dict(chroma_format=2),
    dict(chroma_format=3, rate_control_mode=1, target_bitrate=1000000),
    dict(enable_denoise=True), dict(improve_sharpness=True),
    dict(bit_rate_reduction=True), dict(constrained_motion_tiles=True,
                                        tile_columns=2),
    dict(segment_ov_enabled=True)])
def test_configs_the_host_path_brings_are_accepted(kw):
    Encoder(EncoderConfig(width=256, height=128, intra_period=-1, **kw),
            device="cpu")
