"""The port's B-picture path against the JAX package, on the CPU.

Stage by stage (the two-list bS rule, the B encode pass, the two-list
decision, the two-list merge snap, the whole B-picture device pipeline)
and whole streams (random access with hierarchical levels 1, 2 and 3,
open GOP with CRA and RASL pictures, low-delay B). Tolerance: exact
equality of every array and byte equality of every stream.

One picture size (128x64) and one set of static arguments (M7, CTB 32,
DLF + SAO) run through the whole file, and the JAX stages are called
through jax.jit, so each JAX graph compiles once per test process.
"""

import contextlib

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
from svt_hevc_tpu.tpu import dlf as jdlf
from svt_hevc_tpu.tpu import encode as jenc
from svt_hevc_tpu.tpu.me import hme_search as j_hme
from svt_hevc_tpu_torch import Encoder, EncoderConfig
from svt_hevc_tpu_torch.gpu import dlf as gdlf
from svt_hevc_tpu_torch.gpu import encode as genc
from svt_hevc_tpu_torch.io.yuv import Frame
from tests.test_intra_pass import random_quadtree
from tests.test_torch_encoder import make_frames, one_torch_thread  # noqa: F401

W, H = 128, 64             # coded dims = the 64-aligned grid
QP = 34                    # a layer-1 B picture of a qp-32 stream
QPC = chroma_qp(QP, 0, 1)
LAM = float(np.float32(lambda_sse(QP)))
CTB_LOG2 = 5
# reference POCs relative to the B picture (L0 before, L1 after)
D0, D1 = -2, 2


def T(a):
    """numpy / jax array -> torch tensor (CPU)."""
    return torch.from_numpy(np.array(a))


def eq(got, want, what=""):
    if isinstance(got, torch.Tensor):
        got = got.numpy()
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want),
                                  err_msg=what)


@pytest.fixture(scope="module")
def bpics():
    """POC 0, 2 and 4 of a panned texture as device planes of both sides:
    the B picture is POC 2, its L0 reference POC 0, its L1 reference
    POC 4."""
    frames = make_frames(5, W, H, seed=5)[::2]
    jp = [jenc.prep_planes(y, cb, cr, W, H) for y, cb, cr in frames]
    tp = [genc.prep_planes(y, cb, cr, W, H, "cpu") for y, cb, cr in frames]
    return jp, tp


def _two_list_field(seed):
    """A decided two-list field on a random quadtree: per CU uni-L0,
    uni-L1, bi or (1 in 10) intra, small MVs so the bS rule's 4-unit
    threshold goes both ways."""
    rng = np.random.default_rng(seed)
    nby, nbx = H // 8, W // 8
    cu = np.minimum(random_quadtree(nby, nbx, W, H, rng), CTB_LOG2).astype(
        np.int32)
    kind = rng.integers(0, 10, (nby, nbx))
    mv = rng.integers(-12, 13, (2, nby, nbx, 2)).astype(np.int32)
    for by in range(nby):               # one motion per CU
        for bx in range(nbx):
            k = (1 << cu[by, bx]) // 8
            oy, ox = by // k * k, bx // k * k
            kind[by, bx] = kind[oy, ox]
            mv[:, by, bx] = mv[:, oy, ox]
    use0 = (kind < 6) & (kind != 3)
    use1 = (kind >= 3) & (kind < 9)
    ref8 = np.stack([np.where(use0, 0, -1),
                     np.where(use1, 0, -1)]).astype(np.int32)
    mv = np.where((ref8 >= 0)[..., None], mv, 0).astype(np.int32)
    return cu, ref8, mv


@pytest.mark.parametrize("d0,d1", [(D0, D1), (-1, -1)],
                         ids=["two_pictures", "same_picture_twice"])
def test_derive_bs_maps_two_lists_matches_jax(d0, d1):
    """The two-list bS rule: reference POC sets, uni / bi, one picture in
    both lists (low-delay B) and the cbf / intra strengths."""
    cu, ref8, mv = _two_list_field(11)
    rng = np.random.default_rng(12)
    cbf4 = (rng.random((H // 4, W // 4)) < 0.3).astype(np.int32)
    inter8 = (ref8 >= 0).any(0)
    refpoc = np.stack([np.where(ref8[0] >= 0, d0, gdlf._POC_NONE),
                       np.where(ref8[1] >= 0, d1, gdlf._POC_NONE)]).astype(
        np.int32)
    derive = jax.jit(jdlf.derive_bs_maps, static_argnames=("w", "h"))
    want = derive(jnp.asarray(cu), jnp.asarray(inter8), jnp.asarray(mv[0]),
                  jnp.asarray(cbf4), w=W - 8, h=H - 8,
                  tu_log2_8=jnp.asarray(np.minimum(cu, 5)),
                  refpoc8=jnp.asarray(refpoc), mv8_2l=jnp.asarray(mv))
    got = gdlf.derive_bs_maps(T(cu), T(inter8), T(mv[0]), T(cbf4), W - 8,
                              H - 8, tu_log2_8=T(np.minimum(cu, 5)),
                              refpoc8=T(refpoc), mv8_2l=T(mv))
    for g, w_, name in zip(got, want, ("bs_v", "bs_h")):
        eq(g, w_, name)
    bs_v = np.asarray(want[0])
    assert (bs_v == 1).any() and (bs_v == 2).any()


def test_bi_select_matches_jax():
    rng = np.random.default_rng(3)
    a = rng.integers(-8000, 24000, (H, W)).astype(np.int32)
    b = rng.integers(-8000, 24000, (H, W)).astype(np.int32)
    use0 = rng.random((H // 8, W // 8)) < 0.6
    use1 = ~use0 | (rng.random((H // 8, W // 8)) < 0.5)
    for k, sl in ((8, np.s_[:, :]), (4, np.s_[:H // 2, :W // 2])):
        want = jax.jit(jenc._bi_select, static_argnums=(4, 5))(
            jnp.asarray(a[sl]), jnp.asarray(b[sl]), jnp.asarray(use0),
            jnp.asarray(use1), k, 8)
        got = genc._bi_select(T(a[sl]), T(b[sl]), T(use0), T(use1), k, 8)
        eq(got, want, f"k={k}")


@pytest.fixture(scope="module")
def bencoded(bpics):
    """encode_pass_b_direct (and its mc_pred_b_direct) on a random
    two-list field, RQT split on."""
    jp, tp = bpics
    cu, ref8, mv = _two_list_field(7)
    tu = np.minimum(cu, 5)
    lam = float(np.float32(LAM) * np.float32(1.5))
    epass = jax.jit(jenc.encode_pass_b_direct,
                    static_argnames=("bit_depth", "tu_split"))
    oj = epass(*jp[1], jp[0], jp[2], jnp.asarray(mv), jnp.asarray(ref8),
               jnp.asarray(tu), jnp.int32(QP), jnp.int32(QPC), bit_depth=8,
               lam=jnp.float32(lam), tu_split=True,
               cu_log2_8=jnp.asarray(cu))
    ot = genc.encode_pass_b_direct(*tp[1], tp[0], tp[2], T(mv), T(ref8),
                                   T(tu), QP, QPC, bit_depth=8, lam=lam,
                                   tu_split=True, cu_log2_8=T(cu))
    return oj, ot


def test_encode_pass_b_direct_matches_jax(bencoded):
    oj, ot = bencoded
    for k in oj:
        eq(ot[k], oj[k], k)


def test_mc_pred_b_direct_matches_jax(bpics):
    jp, tp = bpics
    _, ref8, mv = _two_list_field(8)
    mv = mv * 9 - 3                      # sub-pel phases, both signs
    use0, use1 = ref8[0] >= 0, ref8[1] >= 0
    want = jax.jit(jenc.mc_pred_b_direct, static_argnames=("bit_depth",))(
        jp[0], jp[2], jnp.asarray(mv), jnp.asarray(use0),
        jnp.asarray(use1), bit_depth=8)
    got = genc.mc_pred_b_direct(tp[0], tp[2], T(mv), T(use0), T(use1), 8)
    for g, w_, name in zip(got, want, ("y", "cb", "cr")):
        eq(g, w_, name)


@pytest.fixture(scope="module")
def bmd(bpics):
    """Both lists' HME fields and dense MD of the B picture."""
    jp, tp = bpics
    mds = []
    dmd = jax.jit(jenc.dense_md_p, static_argnames=("bit_depth",
                                                    "subpel_min"))
    for ref in (0, 2):
        mv_j, _ = j_hme(jp[1][0], jp[ref][0])
        md_j = dmd(jp[1][0], jp[ref][0], None, mv_j, bit_depth=8,
                   qp=jnp.int32(QP), subpel_min=16)
        md_t = genc.dense_md_p(tp[1][0], tp[ref][0], T(mv_j), bit_depth=8,
                               qp=QP, subpel_min=16)
        for k in jenc.MD_KEYS:
            eq(md_t[k], md_j[k], k)
        mds.append((mv_j, md_j, md_t))
    return mds


@pytest.fixture(scope="module")
def bdecided(bpics, bmd):
    jp, tp = bpics
    (_, md0_j, md0_t), (_, md1_j, md1_t) = bmd
    decide = jax.jit(jenc.decide_tree_b_dev, static_argnames=(
        "ctb_log2", "min_intra_log2", "w", "h", "bit_depth"))
    dj = decide(md0_j, md1_j, {}, ctb_log2=CTB_LOG2, src=jp[1][0],
                ref0=jp[0][0], ref1=jp[2][0], min_intra_log2=6, w=W, h=H,
                qp=jnp.int32(QP), bit_depth=8)
    dt = genc.decide_tree_b_dev(md0_t, md1_t, {}, CTB_LOG2, tp[1][0],
                                tp[0][0], tp[2][0], min_intra_log2=6, w=W,
                                h=H, qp=QP, bit_depth=8)
    return dj, dt


def test_decide_tree_b_dev_matches_jax(bdecided):
    dj, dt = bdecided
    for name, a, b in zip(("cu_log2_8", "ref8_2l", "mv8_2l", "mode8"), dj,
                          dt):
        eq(b, a, name)
    ref8 = np.asarray(dj[1])
    # the decision uses uni-L0, uni-L1 and bi somewhere in the picture
    assert ((ref8[0] >= 0) & (ref8[1] < 0)).any()
    assert ((ref8[1] >= 0) & (ref8[0] < 0)).any()
    assert ((ref8[0] >= 0) & (ref8[1] >= 0)).any()


def test_merge_snap_b_matches_jax(bpics, bdecided):
    jp, tp = bpics
    dj, dt = bdecided
    ext = [(jenc._ext_y(jp[i][0]), genc._ext_y(tp[i][0])) for i in (0, 2)]
    snap = jax.jit(jenc.merge_snap_b, static_argnums=(7, 8, 9, 10))
    mv_j, ref_j = dj[2], dj[1]
    mv_t, ref_t = dt[2], dt[1]
    for _ in range(genc.SNAP_PASSES):
        mv_j, ref_j = snap(jp[1][0], ext[0][0], ext[1][0], mv_j, ref_j,
                           dj[0], jnp.int32(QP), CTB_LOG2, W, H, 8)
        mv_t, ref_t = genc.merge_snap_b(tp[1][0], ext[0][1], ext[1][1],
                                        mv_t, ref_t, dt[0], QP, CTB_LOG2, W,
                                        H, 8)
        eq(mv_t, mv_j, "mv8_2l")
        eq(ref_t, ref_j, "ref8_2l")


def test_fast_b_fused_dev_matches_jax(bpics, bmd):
    """The whole B-picture device pipeline: the packed download is
    byte-equal; recon planes, the 16x16 collocated motion and the full
    level planes are equal."""
    jp, tp = bpics
    (mv0, _, _), (mv1, _, _) = bmd
    rj = jenc.fast_b_fused_dev(
        *jp[1], *jp[0], *jp[2], mv0, mv1, jnp.int32(D0), jnp.int32(D1),
        jnp.int32(QP), jnp.int32(QPC), jnp.float32(LAM), ctb_log2=CTB_LOG2,
        w=W, h=H, bit_depth=8, dlf=True, sao=True, min_intra_log2=6,
        subpel_min=16)
    rt = genc.fast_b_fused_dev(
        *tp[1], *tp[0], *tp[2], T(mv0), T(mv1), D0, D1, QP, QPC, LAM,
        ctb_log2=CTB_LOG2, w=W, h=H, bit_depth=8, dlf=True, sao=True,
        min_intra_log2=6, subpel_min=16)
    assert rt[0].numpy().tobytes() == np.asarray(rj[0]).tobytes()
    for i in range(1, 6):
        eq(rt[i], rj[i], f"output {i}")
    for a, b in zip(rj[6], rt[6]):
        eq(b, a, "lv_full")


def test_b_lambda_table_matches_the_jax_b_graph():
    """decide_tree_b_dev's float32 SSE lambda, evaluated as its graph
    does, equals the port's table at every QP a qp-32 B picture reaches
    (layers 1-5) and every other QP."""
    @jax.jit
    def lam_b(qp):
        return jenc.P_LAMBDA_SCALE * jnp.float32(0.57) * jnp.exp2(
            (qp.astype(jnp.float32) - 12.0) / 3.0)

    for qp in list(range(33, 39)) + [q for q in range(52)
                                     if not 33 <= q < 39]:
        assert np.float32(lam_b(jnp.int32(qp))) == genc._LAM_SSE_P[qp], qp


# ------------------------------------------------------------ whole streams

STREAMS = {
    "ra_hl2_x5": (dict(pred_structure=2, hierarchical_levels=2), 5),
    "ra_hl1_x6": (dict(pred_structure=2, hierarchical_levels=1), 6),
    "ldb_x3": (dict(pred_structure=1), 3),
    # a CRA at POC 8 with the RASL pictures 6, 5 and 7
    "open_gop_x9": (dict(pred_structure=2, hierarchical_levels=2,
                         intra_refresh_type=1, intra_period=7), 9),
    # P16's collocated POC 8 has left the device motion cache (cap 6)
    "ra_hl3_x17": (dict(pred_structure=2, hierarchical_levels=3), 17),
}


def _cfg_kw(name):
    kw, _ = STREAMS[name]
    return dict(dict(width=W, height=H, qp=32, enc_mode=7, intra_period=-1),
                **kw)


@pytest.fixture(scope="module", params=list(STREAMS))
def bstreams(request):
    kw, n = STREAMS[request.param]
    planes = make_frames(n, W, H, seed=3)
    s_j, rec_j = JEncoder(JCfg(**_cfg_kw(request.param))).encode(
        [JFrame(y=y, cb=cb, cr=cr) for y, cb, cr in planes])
    s_t, rec_t = Encoder(EncoderConfig(**_cfg_kw(request.param)),
                         device="cpu").encode(
        [Frame(y=y, cb=cb, cr=cr) for y, cb, cr in planes])
    return request.param, s_j, rec_j, s_t, rec_t


def test_b_stream_byte_identical_to_jax(bstreams):
    _, s_j, rec_j, s_t, rec_t = bstreams
    assert s_t == s_j
    assert len(rec_t) == len(rec_j)
    for a, b in zip(rec_j, rec_t):
        for p in ("y", "cb", "cr"):
            np.testing.assert_array_equal(getattr(a, p), getattr(b, p))


def test_b_stream_decodes_to_recon(bstreams):
    from svt_hevc_tpu_torch.bitstream.nal import NalUnitType
    from svt_hevc_tpu_torch.decoder.decoder import decode_stream
    name, _, _, s_t, rec_t = bstreams
    dec = decode_stream(s_t)
    assert len(dec) == len(rec_t)
    for d, r in zip(dec, rec_t):
        for p in ("y", "cb", "cr"):
            np.testing.assert_array_equal(getattr(d, p), getattr(r, p))
    types, i = [], 0
    while (j := s_t.find(b"\x00\x00\x01", i)) >= 0:
        types.append((s_t[j + 3] >> 1) & 0x3F)
        i = j + 3
    if name == "open_gop_x9":
        assert types.count(int(NalUnitType.CRA_NUT)) == 1
        assert (types.count(int(NalUnitType.RASL_R))
                + types.count(int(NalUnitType.RASL_N))) == 3


def test_ra_p_anchor_loses_its_evicted_collocated_motion():
    """At hl=3 the decode order I0 P8 B4 B2 B1 B3 B6 B5 B7 registers nine
    pictures' motion, so POC 8 has left the six-entry device motion cache
    when P16 is dispatched: both encoders then decide P16 without the
    TMVP candidate (and their streams agree, test above)."""
    frames = [Frame(y=y, cb=cb, cr=cr)
              for y, cb, cr in make_frames(17, W, H, seed=3)]
    enc = Encoder(EncoderConfig(**_cfg_kw("ra_hl3_x17")), device="cpu")
    jenc_ = JEncoder(JCfg(**_cfg_kw("ra_hl3_x17")))
    seen = []
    for au_t, au_j in zip(enc.encode_pictures(frames),
                          jenc_.encode_pictures(
                              [JFrame(y=f.y, cb=f.cb, cr=f.cr)
                               for f in frames])):
        assert au_t.data == au_j.data
        seen.append(au_t.poc)
        if au_t.poc == 7:
            break
    assert seen == [0, 8, 4, 2, 1, 3, 6, 5, 7]
    key = (8, W, H)
    assert key not in enc._dev_motion and key not in jenc_._dev_motion
    assert 8 in enc._ref_motion


def test_ra_generator_yields_as_it_encodes():
    """The first three access units (I0, P4, B2) come out without the
    rest of the sequence being encoded."""
    from svt_hevc_tpu_torch.pipeline import encoder as penc

    frames = [Frame(y=y, cb=cb, cr=cr)
              for y, cb, cr in make_frames(9, W, H, seed=3)]
    enc = Encoder(EncoderConfig(**_cfg_kw("ra_hl2_x5")), device="cpu")
    calls = []
    orig = penc.Encoder.encode_frame

    def counting(self, *a, **kw):
        calls.append(kw.get("poc"))
        return orig(self, *a, **kw)

    with contextlib.ExitStack() as stack:
        stack.callback(setattr, penc.Encoder, "encode_frame", orig)
        penc.Encoder.encode_frame = counting
        gen = enc.encode_pictures(frames)
        aus = [next(gen) for _ in range(3)]
        gen.close()
    assert [(a.poc, a.slice_type) for a in aus] == [(0, 2), (4, 1), (2, 0)]
    assert calls == [0, 4, 2]
