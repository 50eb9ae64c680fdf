"""The port's I-picture device stages against the JAX package: open-loop
intra search (gpu.analysis), the intra quadtree decision, the closed-loop
wavefront pass (gpu.intra_pass) and the fused I picture, at 128x256.

Tolerance: exact equality. The open-loop costs are float32 sums of dyadic
values that stay exact, the closed loop is integer arithmetic, and the
packed download must be byte-equal.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from svt_hevc_tpu.core.ctu import chroma_qp
from svt_hevc_tpu.core.rdo import lambda_sse
from svt_hevc_tpu.tpu import analysis as jan
from svt_hevc_tpu.tpu import encode as jenc
from svt_hevc_tpu.tpu.intra_pass import intra_wavefront_pass as j_wave
from svt_hevc_tpu_torch.gpu import analysis as gan
from svt_hevc_tpu_torch.gpu import encode as genc
from svt_hevc_tpu_torch.gpu.intra_pass import intra_wavefront_pass
from tests.test_torch_encode import T, eq
from tests.test_torch_encoder import make_frames, one_torch_thread  # noqa: F401

W, H = 256, 120            # coded dims on a 128 x 256 grid
W64, H64 = 256, 128
QP = 32
QPC = chroma_qp(QP, 0, 1)
LAM = float(np.float32(lambda_sse(QP)))
CTB_LOG2 = 5


@pytest.fixture(scope="module")
def planes():
    y, cb, cr = make_frames(1, W, H, seed=9)[0]
    return (jenc.prep_planes(y, cb, cr, W64, H64),
            genc.prep_planes(y, cb, cr, W64, H64, "cpu"))


@pytest.mark.parametrize("n", [8, 16, 32])
def test_intra_search_size_matches_jax(planes, n):
    jp, tp = planes
    yj, yt = jp[0].astype(jnp.float32), tp[0].to(torch.float32)
    mj, cj = jan.intra_search_size(yj, n)
    mt, ct = gan.intra_search_size(yt, n)
    eq(mt, mj, "mode")
    eq(ct, cj, "cost")
    mj, cj, pj = jan.intra_search_size_pred(yj, n, 8)
    mt, ct, pt = gan.intra_search_size_pred(yt, n, 8)
    eq(mt, mj, "mode")
    eq(ct, cj, "cost")
    eq(pt, pj, "pred plane")


def test_decide_tree_i_dev_matches_jax(planes):
    jp, tp = planes
    ois_j, preds_j, ois_t, preds_t = {}, {}, {}, {}
    for n in (8, 16, 32):
        m, c, p = jan.intra_search_size_pred(jp[0].astype(jnp.float32), n)
        ois_j[n] = (m, jnp.round(c).astype(jnp.int32))
        preds_j[n] = p
        m, c, p = gan.intra_search_size_pred(tp[0].to(torch.float32), n)
        ois_t[n] = (m, torch.round(c).to(torch.int32))
        preds_t[n] = p
    decide = jax.jit(jenc.decide_tree_i_dev,
                     static_argnames=("ctb_log2", "w", "h", "bit_depth"))
    cj, mj = decide(ois_j, jnp.int32(QP), ctb_log2=CTB_LOG2, w=W, h=H,
                    src=jp[0], preds=preds_j)
    ct, mt = genc.decide_tree_i_dev(ois_t, QP, CTB_LOG2, W, H, src=tp[0],
                                    preds=preds_t)
    eq(ct, cj, "cu_log2_8")
    eq(mt, mj, "mode8")


def test_intra_wavefront_pass_p_form_matches_jax(planes):
    """The P-picture form: only CUs flagged intra (>= 16, min_cu_log2 4)
    are coded, on top of an existing reconstruction, with closed-loop mode
    refinement and the RD zero-out."""
    jp, tp = planes
    rng = np.random.default_rng(4)
    nby, nbx = H64 // 8, W64 // 8
    # each 32x32 region is one 32-CU or four 16-CUs
    cu = np.where(rng.random((nby // 4, nbx // 4)) < 0.5, 4, 5)
    cu = np.repeat(np.repeat(cu, 4, 0), 4, 1).astype(np.int32)
    mode = rng.integers(0, 35, (nby, nbx)).astype(np.int32)
    intra = rng.random((nby, nbx)) < 0.4
    rec = [rng.integers(0, 256, s).astype(np.int32)
           for s in ((H64, W64), (H64 // 2, W64 // 2), (H64 // 2, W64 // 2))]
    lv = [np.zeros_like(r) for r in rec]
    wave = jax.jit(j_wave, static_argnames=(
        "w", "h", "bit_depth", "ctb_log2", "min_cu_log2", "refine_modes"))
    oj = wave(*jp, *(jnp.asarray(r) for r in rec),
              *(jnp.asarray(x) for x in lv), jnp.asarray(cu),
              jnp.asarray(mode), jnp.asarray(intra), jnp.int32(QP),
              jnp.int32(QPC), w=W, h=H, ctb_log2=CTB_LOG2, min_cu_log2=4,
              lam=jnp.float32(LAM), refine_modes=True)
    ot = intra_wavefront_pass(*tp, *(T(r) for r in rec), *(T(x) for x in lv),
                              T(cu), T(mode), T(intra), QP, QPC, w=W, h=H,
                              ctb_log2=CTB_LOG2, min_cu_log2=4, lam=LAM,
                              refine_modes=True)
    for i, (a, b) in enumerate(zip(oj, ot)):
        eq(b, a, f"output {i}")


def test_fast_i_fused_dev_matches_jax(planes):
    """The whole I picture: the packed download is byte-equal, recon and
    level planes equal."""
    jp, tp = planes
    rj = jenc.fast_i_fused_dev(*jp, jnp.int32(QP), jnp.int32(QPC),
                               jnp.float32(LAM), ctb_log2=CTB_LOG2, w=W, h=H)
    rt = genc.fast_i_fused_dev(*tp, QP, QPC, LAM, ctb_log2=CTB_LOG2, w=W,
                               h=H)
    assert rt[0].numpy().tobytes() == np.asarray(rj[0]).tobytes()
    for i in range(1, 6):
        eq(rt[i], rj[i], f"output {i}")
    for a, b in zip(rj[6], rt[6]):
        eq(b, a, "lv_full")
