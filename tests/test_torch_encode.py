"""The port's P-picture device stages (svt_hevc_tpu_torch.gpu.encode)
against svt_hevc_tpu.tpu.encode, stage by stage, on the same inputs.

Tolerance: exact equality of every output array (and byte equality of
the packed download). The JAX stages are integer-exact, or float32 with
integer-valued sums, and the port reproduces them bit for bit.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from svt_hevc_tpu.core.ctu import chroma_qp
from svt_hevc_tpu.core.rdo import lambda_sse
from svt_hevc_tpu.tpu import encode as jenc
from svt_hevc_tpu.tpu.me import hme_search as j_hme
from svt_hevc_tpu_torch.gpu import encode as genc
from tests.test_intra_pass import random_quadtree
from tests.test_torch_encoder import make_frames, one_torch_thread  # noqa: F401

W, H = 256, 120            # coded dims; the 64-aligned grid is 256 x 128
W64, H64 = 256, 128
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


@pytest.fixture(scope="module")
def pics():
    """Two consecutive pictures of a panned texture on both sides: JAX
    device planes (via the JAX prep_planes) and the port's."""
    frames = make_frames(2, W, H, seed=5)
    jp = [jenc.prep_planes(y, cb, cr, W64, H64) for y, cb, cr in frames]
    tp = [genc.prep_planes(y, cb, cr, W64, H64, "cpu")
          for y, cb, cr in frames]
    return jp, tp


def test_prep_planes_matches_jax(pics):
    jp, tp = pics
    for a, b in zip(jp, tp):
        for x, y in zip(a, b):
            eq(y, x)
            assert y.dtype == torch.int32


@pytest.mark.parametrize("n", [4, 8, 16, 32])
@pytest.mark.parametrize("bd", [8, 10])
def test_dense_tq_size_matches_jax(n, bd):
    rng = np.random.default_rng(n * bd)
    mx = (1 << bd) - 1
    resid = rng.integers(-mx, mx + 1, (64, 64)).astype(np.int32)
    resid[:16] //= 16                      # small residual: RD zero-outs
    for is_intra in (False, True):
        for lam in (None, LAM * 1.5):
            lj = None if lam is None else jnp.float32(lam)
            want = jenc.dense_tq_size(jnp.asarray(resid), n, jnp.int32(QP),
                                      bit_depth=bd, is_intra=is_intra,
                                      lam=lj)
            got = genc.dense_tq_size(T(resid), n, QP, bit_depth=bd,
                                     is_intra=is_intra, lam=lam)
            for g, w_ in zip(got, want):
                eq(g, w_, f"n={n} bd={bd} intra={is_intra} lam={lam}")


@pytest.fixture(scope="module")
def md(pics):
    jp, tp = pics
    mv_j, _ = j_hme(jp[1][0], jp[0][0])
    md_j = jenc.dense_md_p(jp[1][0], jp[0][0], None, mv_j, bit_depth=8,
                           qp=jnp.int32(QP), subpel_min=16)
    md_t = genc.dense_md_p(tp[1][0], tp[0][0], T(mv_j), bit_depth=8, qp=QP,
                           subpel_min=16)
    return md_j, md_t


def test_dense_md_p_matches_jax(md):
    md_j, md_t = md
    for k in jenc.MD_KEYS:
        eq(md_t[k], md_j[k], k)


def _tmvp_field(seed):
    rng = np.random.default_rng(seed)
    mv = rng.integers(-40, 41, (H64 // 16, W64 // 16, 2)).astype(np.int32)
    valid = rng.random((H64 // 16, W64 // 16)) < 0.7
    return mv, valid


@pytest.fixture(scope="module")
def decided(pics, md):
    """decide_tree_dev with a nonzero, POC-scaled TMVP field (tb=1, td=2)
    on both sides."""
    jp, tp = pics
    md_j, md_t = md
    col_mv, col_valid = _tmvp_field(1)
    decide = jax.jit(jenc.decide_tree_dev, static_argnames=(
        "ctb_log2", "min_intra_log2", "w", "h", "bit_depth"))
    dj = decide(
        md_j, {}, ctb_log2=CTB_LOG2, min_intra_log2=6, w=W, h=H,
        qp=jnp.int32(QP), src=jp[1][0], ref=jp[0][0], bit_depth=8,
        col_mv8=jnp.asarray(col_mv), col_valid8=jnp.asarray(col_valid),
        tb=jnp.int32(1), td=jnp.int32(2))
    dt = genc.decide_tree_dev(
        md_t, {}, CTB_LOG2, min_intra_log2=6, w=W, h=H, qp=QP,
        src=tp[1][0], ref=tp[0][0], bit_depth=8, col_mv8=T(col_mv),
        col_valid8=T(col_valid), tb=1, td=2)
    return dj, dt, (col_mv, col_valid)


def test_decide_tree_dev_matches_jax(decided):
    dj, dt, _ = decided
    for name, a, b in zip(("cu_log2_8", "inter8", "mv8", "mode8"), dj, dt):
        eq(b, a, name)


def test_merge_snap_matches_jax(pics, decided):
    jp, tp = pics
    dj, dt, (col_mv, col_valid) = decided
    ext_j = jenc._ext_y(jp[0][0])
    ext_t = genc._ext_y(tp[0][0])
    mv_j, mv_t = dj[2], dt[2]
    snap = jax.jit(jenc.merge_snap, static_argnums=(10, 11, 12))
    for _ in range(jenc.SNAP_PASSES):
        mv_j = snap(jp[1][0], ext_j, mv_j, dj[1], dj[0],
                               jnp.int32(QP), jnp.asarray(col_mv),
                               jnp.asarray(col_valid), jnp.int32(1),
                               jnp.int32(2), CTB_LOG2, W, H)
        mv_t = genc.merge_snap(tp[1][0], ext_t, mv_t, dt[1], dt[0], QP,
                               T(col_mv), T(col_valid), 1, 2, CTB_LOG2, W, H)
        eq(mv_t, mv_j)


@pytest.fixture(scope="module")
def encoded(pics):
    """encode_pass_p_direct on a random quadtree with random MVs and ~20%
    intra blocks, RQT split on."""
    jp, tp = pics
    rng = np.random.default_rng(7)
    nby, nbx = H64 // 8, W64 // 8
    cu = random_quadtree(nby, nbx, W, H, rng).astype(np.int32)
    cu = np.minimum(cu, CTB_LOG2)
    inter = rng.random((nby, nbx)) < 0.8
    mv = rng.integers(-120, 121, (nby, nbx, 2)).astype(np.int32)
    for by in range(nby):               # one MV / mode per CU
        for bx in range(nbx):
            k = (1 << cu[by, bx]) // 8
            oy, ox = by // k * k, bx // k * k
            inter[by, bx] = inter[oy, ox]
            mv[by, bx] = mv[oy, ox]
    tu = np.minimum(cu, 5)
    lam = float(np.float32(LAM) * np.float32(1.5))
    epass = jax.jit(jenc.encode_pass_p_direct,
                    static_argnames=("bit_depth", "tu_split"))
    oj = epass(
        *jp[1], *jp[0], jnp.asarray(mv), jnp.asarray(inter),
        jnp.asarray(tu), jnp.int32(QP), jnp.int32(QPC), bit_depth=8,
        lam=jnp.float32(lam), tu_split=True, cu_log2_8=jnp.asarray(cu))
    ot = genc.encode_pass_p_direct(
        *tp[1], *tp[0], T(mv), T(inter), T(tu), QP, QPC, bit_depth=8,
        lam=lam, tu_split=True, cu_log2_8=T(cu))
    return oj, ot, (cu, inter, mv)


def test_encode_pass_p_direct_matches_jax(encoded):
    oj, ot, _ = encoded
    for k in oj:
        eq(ot[k], oj[k], k)


def test_finish_fused_matches_jax(pics, encoded):
    """cbf map -> DLF -> SAO -> edge pad -> compaction + pack."""
    jp, tp = pics
    oj, ot, (cu, inter, mv) = encoded
    keys = ("rec_y", "rec_cb", "rec_cr")
    lkeys = ("lv_y", "lv_cb", "lv_cr")
    finish = jax.jit(jenc._finish_fused, static_argnums=tuple(range(10, 16)))
    fj = finish(
        jp[1], tuple(oj[k].astype(jnp.int32) for k in keys),
        tuple(oj[k].astype(jnp.int32) for k in lkeys), jnp.asarray(cu),
        jnp.asarray(inter), jnp.asarray(mv), oj["tu8"], jnp.int32(QP),
        jnp.int32(QPC), jnp.float32(LAM), CTB_LOG2, W, H, 8, True, True)
    ft = genc._finish_fused(
        tp[1], tuple(ot[k] for k in keys), tuple(ot[k] for k in lkeys),
        T(cu), T(inter), T(mv), ot["tu8"], QP, QPC, LAM, CTB_LOG2, W, H, 8,
        True, True)
    eq(ft[0], fj[0], "packed")
    assert ft[0].numpy().tobytes() == np.asarray(fj[0]).tobytes()
    for i in (1, 2, 3):
        eq(ft[i], fj[i], f"rec {i}")
    for a, b in zip(fj[4], ft[4]):
        eq(b, a, "lv_full")


@pytest.mark.parametrize("tb,td", [(1, 1), (1, 2)])
def test_fast_p_fused_dev_matches_jax(pics, tb, td):
    """The whole P-picture device pipeline: the packed download is
    byte-equal; recon planes, the 16x16 collocated motion and the full
    level planes are equal."""
    jp, tp = pics
    mv_j, _ = j_hme(jp[1][0], jp[0][0])
    col_mv, col_valid = _tmvp_field(tb + td)
    rj = jenc.fast_p_fused_dev(
        *jp[1], *jp[0], mv_j, jnp.int32(QP), jnp.int32(QPC),
        jnp.float32(LAM), jnp.asarray(col_mv), jnp.asarray(col_valid),
        jnp.int32(tb), jnp.int32(td), ctb_log2=CTB_LOG2, w=W, h=H,
        bit_depth=8, dlf=True, sao=True, min_intra_log2=6, subpel_min=16)
    rt = genc.fast_p_fused_dev(
        *tp[1], *tp[0], T(mv_j), QP, QPC, LAM, T(col_mv), T(col_valid), tb,
        td, ctb_log2=CTB_LOG2, w=W, h=H, bit_depth=8, dlf=True, sao=True,
        min_intra_log2=6, subpel_min=16)
    assert rt[0].numpy().tobytes() == np.asarray(rj[0]).tobytes()
    for i in range(1, 6):
        eq(rt[i], rj[i], f"output {i}")
    for a, b in zip(rj[6], rt[6]):
        eq(b, a, "lv_full")
