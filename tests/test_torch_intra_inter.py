"""Intra CUs inside P and B pictures (presets M8-M9): the port against
the JAX package, on the CPU.

The decisions with intra offered (decide_tree_dev, decide_tree_b_dev at
min_intra_log2 5 and 4, 8-bit and 10-bit, with the open-loop intra
search maps of intra_search_size), the P- and B-picture device pipelines
with their intra branch (the closed-loop wavefront over the inter
reconstruction), and whole M8 / M9 streams (IPPP, random access hl=2,
low-delay B). Tolerance: exact equality of every array and byte equality
of every stream. The content puts a new textured patch into every
picture, so the decisions choose intra CUs in P and B pictures, and the
tests assert that they did.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from svt_hevc_tpu.config import EncoderConfig as JCfg
from svt_hevc_tpu.core.ctu import chroma_qp
from svt_hevc_tpu.core.rdo import lambda_sse
from svt_hevc_tpu.io.yuv import Frame as JFrame
from svt_hevc_tpu.pipeline.encoder import Encoder as JEncoder
from svt_hevc_tpu.tpu import encode as jenc
from svt_hevc_tpu.tpu.analysis import intra_search_size as j_ois
from svt_hevc_tpu.tpu.me import hme_search as j_hme
from svt_hevc_tpu_torch import Encoder, EncoderConfig
from svt_hevc_tpu_torch.decoder.decoder import decode_stream
from svt_hevc_tpu_torch.gpu import encode as genc
from svt_hevc_tpu_torch.gpu import intra_pass
from svt_hevc_tpu_torch.gpu.analysis import intra_search_size as t_ois
from svt_hevc_tpu_torch.io.yuv import Frame
from tests.test_torch_encoder import make_frames, one_torch_thread  # noqa: F401

W, H = 128, 64             # coded dims = the 64-aligned grid
QP = 32
QPC = chroma_qp(QP, 0, 1)
LAM = float(np.float32(lambda_sse(QP)))
CTB_LOG2 = 5


def T(a):
    """numpy / jax array -> torch tensor (CPU)."""
    return torch.from_numpy(np.array(a))


def eq(got, want, what=""):
    if isinstance(got, torch.Tensor):
        got = got.numpy()
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want),
                                  err_msg=what)


def intra_frames(n, w, h, bit_depth=8, seed=7):
    """make_frames' panned texture with a new 32x32 patch at a new place
    in every picture after the first: a smooth ramp whose slopes and
    direction change from picture to picture, so no reference holds it
    and intra predicts it well. Returns (y, cb, cr) tuples; 10-bit
    content is the 8-bit content times 4 plus seeded 2-bit noise."""
    rng = np.random.default_rng(seed)
    a = np.arange(32)
    out = []
    for i, (y, cb, cr) in enumerate(make_frames(n, w, h, seed=seed)):
        y = y.copy()
        if i >= 1:
            ys = (16 + 8 * i) % (h - 32)
            xs = (32 + 16 * i) % (w - 32)
            sy, sx = 1 + i % 3, 1 + (2 * i) % 3
            ramp = 30 + np.add.outer(sy * a, sx * a)
            ramp = ramp[::(-1) ** i, ::(-1) ** (i // 2)]
            y[ys:ys + 32, xs:xs + 32] = ramp
        if bit_depth == 10:
            y, cb, cr = (p.astype(np.uint16) * 4
                         + rng.integers(0, 4, p.shape).astype(np.uint16)
                         for p in (y, cb, cr))
        out.append((y, cb, cr))
    return out


def _ois_pair(jy, ty):
    """The open-loop intra maps the fused fronts hand the decision (16
    and 32), from both packages."""
    oj, ot = {}, {}
    for n in (16, 32):
        m, c = j_ois(jy.astype(jnp.float32), n)
        oj[n] = (m.astype(jnp.int32), jnp.round(c).astype(jnp.int32))
        m, c = t_ois(ty.to(torch.float32), n)
        ot[n] = (m.to(torch.int32), torch.round(c).to(torch.int32))
        eq(ot[n][0], oj[n][0], f"ois mode {n}")
        eq(ot[n][1], oj[n][1], f"ois cost {n}")
    return oj, ot


def make_ipics(bd):
    """POC 0, 1 and 2 as device planes of both sides, with each side's
    dense MD of POC 1 against POC 0 and against POC 2, and its OIS maps."""
    frames = intra_frames(3, W, H, bit_depth=bd)
    jp = [jenc.prep_planes(y, cb, cr, W, H) for y, cb, cr in frames]
    tp = [genc.prep_planes(y, cb, cr, W, H, "cpu") for y, cb, cr in frames]
    dmd = jax.jit(jenc.dense_md_p, static_argnames=("bit_depth",
                                                    "subpel_min"))
    mds = []
    for ref in (0, 2):
        mv_j, _ = j_hme(jp[1][0], jp[ref][0])
        md_j = dmd(jp[1][0], jp[ref][0], None, mv_j, bit_depth=bd,
                   qp=jnp.int32(QP), subpel_min=32)
        md_t = genc.dense_md_p(tp[1][0], tp[ref][0], T(mv_j), bit_depth=bd,
                               qp=QP, subpel_min=32)
        mds.append((mv_j, md_j, md_t))
    ois = _ois_pair(jp[1][0], tp[1][0])
    return bd, jp, tp, mds, ois


@pytest.fixture(scope="module", params=[8, 10])
def ipics(request):
    return make_ipics(request.param)


@pytest.fixture(scope="module")
def ipics8():
    """8-bit pictures for the fused pipelines (test_torch_10bit.py runs
    them at 10-bit)."""
    return make_ipics(8)


@pytest.mark.parametrize("min_intra", [5, 4])
def test_decide_tree_dev_with_intra_matches_jax(ipics, min_intra):
    bd, jp, tp, mds, (oj, ot) = ipics
    (_, md_j, md_t), _ = mds
    decide = jax.jit(jenc.decide_tree_dev, static_argnames=(
        "ctb_log2", "min_intra_log2", "w", "h", "bit_depth"))
    zmv = np.zeros((H // 16, W // 16, 2), np.int32)
    zval = np.zeros((H // 16, W // 16), bool)
    dj = decide(md_j, oj, ctb_log2=CTB_LOG2, min_intra_log2=min_intra, w=W,
                h=H, qp=jnp.int32(QP), src=jp[1][0], ref=jp[0][0],
                bit_depth=bd, col_mv8=jnp.asarray(zmv),
                col_valid8=jnp.asarray(zval), tb=jnp.int32(1),
                td=jnp.int32(1))
    dt = genc.decide_tree_dev(md_t, ot, CTB_LOG2, min_intra_log2=min_intra,
                              w=W, h=H, qp=QP, src=tp[1][0], ref=tp[0][0],
                              bit_depth=bd, col_mv8=T(zmv),
                              col_valid8=T(zval), tb=1, td=1)
    for name, a, b in zip(("cu_log2_8", "inter8", "mv8", "mode8"), dj, dt):
        eq(b, a, name)
    assert not np.asarray(dj[1]).all(), "no intra CU was decided"


@pytest.mark.parametrize("min_intra", [5, 4])
def test_decide_tree_b_dev_with_intra_matches_jax(ipics, min_intra):
    bd, jp, tp, mds, (oj, ot) = ipics
    (_, md0_j, md0_t), (_, md1_j, md1_t) = mds
    decide = jax.jit(jenc.decide_tree_b_dev, static_argnames=(
        "ctb_log2", "min_intra_log2", "w", "h", "bit_depth"))
    dj = decide(md0_j, md1_j, oj, ctb_log2=CTB_LOG2, src=jp[1][0],
                ref0=jp[0][0], ref1=jp[2][0], min_intra_log2=min_intra, w=W,
                h=H, qp=jnp.int32(QP + 2), bit_depth=bd)
    dt = genc.decide_tree_b_dev(md0_t, md1_t, ot, CTB_LOG2, tp[1][0],
                                tp[0][0], tp[2][0], min_intra_log2=min_intra,
                                w=W, h=H, qp=QP + 2, bit_depth=bd)
    for name, a, b in zip(("cu_log2_8", "ref8_2l", "mv8_2l", "mode8"), dj,
                          dt):
        eq(b, a, name)
    assert (np.asarray(dj[1]) < 0).all(0).any(), "no intra CU was decided"


def _intra_blocks(valid16):
    """In-picture 16x16 blocks whose collocated motion is invalid: the
    intra CUs of the picture."""
    return int((~valid16.numpy()[:H // 16, :W // 16]).sum())


def check_fast_p_with_intra(ipics):
    """The P-picture device pipeline at M8 (min_intra_log2 5): the packed
    download is byte-equal, recon, collocated motion and level planes are
    equal, and the wavefront ran over intra CUs."""
    bd, jp, tp, mds, _ = ipics
    (mv_j, _, _), _ = mds
    zmv = np.zeros((H // 16, W // 16, 2), np.int32)
    zval = np.zeros((H // 16, W // 16), bool)
    rj = jenc.fast_p_fused_dev(
        *jp[1], *jp[0], mv_j, jnp.int32(QP), jnp.int32(QPC),
        jnp.float32(LAM), jnp.asarray(zmv), jnp.asarray(zval),
        jnp.int32(1), jnp.int32(1), ctb_log2=CTB_LOG2, w=W, h=H,
        bit_depth=bd, dlf=True, sao=True, min_intra_log2=5, subpel_min=32)
    runs = intra_pass.WAVEFRONT["runs"]
    rt = genc.fast_p_fused_dev(
        *tp[1], *tp[0], T(mv_j), QP, QPC, LAM, T(zmv), T(zval), 1, 1,
        ctb_log2=CTB_LOG2, w=W, h=H, bit_depth=bd, dlf=True, sao=True,
        min_intra_log2=5, subpel_min=32)
    assert rt[0].numpy().tobytes() == np.asarray(rj[0]).tobytes()
    for i in range(1, 6):
        eq(rt[i], rj[i], f"output {i}")
    for a, b in zip(rj[6], rt[6]):
        eq(b, a, "lv_full")
    assert _intra_blocks(rt[5]) > 0
    assert intra_pass.WAVEFRONT["runs"] == runs + 1


def check_fast_b_with_intra(ipics):
    """The B-picture device pipeline at M9 (min_intra_log2 5), POC 1
    between POC 0 and POC 2."""
    bd, jp, tp, mds, _ = ipics
    (mv0, _, _), (mv1, _, _) = mds
    qp = QP + 2
    qpc = chroma_qp(qp, 0, 1)
    lam = float(np.float32(lambda_sse(qp)))
    rj = jenc.fast_b_fused_dev(
        *jp[1], *jp[0], *jp[2], mv0, mv1, jnp.int32(-1), jnp.int32(1),
        jnp.int32(qp), jnp.int32(qpc), jnp.float32(lam), ctb_log2=CTB_LOG2,
        w=W, h=H, bit_depth=bd, dlf=True, sao=True, min_intra_log2=5,
        subpel_min=32)
    rt = genc.fast_b_fused_dev(
        *tp[1], *tp[0], *tp[2], T(mv0), T(mv1), -1, 1, qp, qpc, lam,
        ctb_log2=CTB_LOG2, w=W, h=H, bit_depth=bd, dlf=True, sao=True,
        min_intra_log2=5, subpel_min=32)
    assert rt[0].numpy().tobytes() == np.asarray(rj[0]).tobytes()
    for i in range(1, 6):
        eq(rt[i], rj[i], f"output {i}")
    for a, b in zip(rj[6], rt[6]):
        eq(b, a, "lv_full")
    assert _intra_blocks(rt[5]) > 0


def test_fast_p_fused_dev_with_intra_matches_jax(ipics8):
    check_fast_p_with_intra(ipics8)


def test_fast_b_fused_dev_with_intra_matches_jax(ipics8):
    check_fast_b_with_intra(ipics8)


STREAMS = {
    "m8_ippp_x4": (dict(enc_mode=8), 4),
    "m9_ra_hl2_x5": (dict(enc_mode=9, pred_structure=2,
                          hierarchical_levels=2), 5),
    "m8_ldb_x3": (dict(enc_mode=8, pred_structure=1), 3),
}


@pytest.fixture(scope="module", params=list(STREAMS))
def istreams(request):
    kw, n = STREAMS[request.param]
    kw = dict(width=W, height=H, qp=QP, intra_period=-1, **kw)
    planes = intra_frames(n, W, H)
    s_j, rec_j = JEncoder(JCfg(**kw)).encode(
        [JFrame(y=y, cb=cb, cr=cr) for y, cb, cr in planes])
    before = dict(intra_pass.WAVEFRONT)
    s_t, rec_t = Encoder(EncoderConfig(**kw), device="cpu").encode(
        [Frame(y=y, cb=cb, cr=cr) for y, cb, cr in planes])
    runs = intra_pass.WAVEFRONT["runs"] - before["runs"]
    return s_j, rec_j, s_t, rec_t, runs


def test_m8_m9_stream_byte_identical_to_jax(istreams):
    s_j, rec_j, s_t, rec_t, runs = istreams
    assert s_t == s_j
    for a, b in zip(rec_j, rec_t):
        for p in ("y", "cb", "cr"):
            np.testing.assert_array_equal(getattr(a, p), getattr(b, p))
    # the IDR runs the wavefront once; every other run is an inter
    # picture's intra fixup
    assert runs >= 2


def test_m8_m9_stream_decodes_to_recon(istreams):
    _, _, s_t, rec_t, _ = istreams
    dec = decode_stream(s_t)
    assert len(dec) == len(rec_t)
    for d, r in zip(dec, rec_t):
        for p in ("y", "cb", "cr"):
            np.testing.assert_array_equal(getattr(d, p), getattr(r, p))
