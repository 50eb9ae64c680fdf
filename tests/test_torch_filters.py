"""The port's in-loop filters against the JAX package: boundary
strengths and deblocking (gpu.dlf), SAO statistics (gpu.encode
.sao_stats_plane), the SAO decision and its application (gpu.sao).

Tolerance: exact equality. Deblocking is integer arithmetic; the SAO
statistics are integer sums the JAX graph takes in float32 below 2^24
(exact); the decision's float32 math compares the same values.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from svt_hevc_tpu.core.ctu import chroma_qp
from svt_hevc_tpu.core.rdo import lambda_sse
from svt_hevc_tpu.tpu import dlf as jdlf
from svt_hevc_tpu.tpu import encode as jenc
from svt_hevc_tpu.tpu import sao as jsao
from svt_hevc_tpu_torch.gpu import dlf as gdlf
from svt_hevc_tpu_torch.gpu import encode as genc
from svt_hevc_tpu_torch.gpu import sao as gsao
from tests.test_intra_pass import random_quadtree
from tests.test_torch_encode import T, eq
from tests.test_torch_encoder import one_torch_thread  # noqa: F401


def _decisions(w, h, seed):
    rng = np.random.default_rng(seed)
    w64, h64 = (w + 63) // 64 * 64, (h + 63) // 64 * 64
    nby, nbx = h64 // 8, w64 // 8
    cu = random_quadtree(nby, nbx, w, h, rng).astype(np.int32)
    inter = rng.random((nby, nbx)) < 0.8
    mv = rng.integers(-24, 25, (nby, nbx, 2)).astype(np.int32)
    for by in range(nby):
        for bx in range(nbx):
            k = (1 << cu[by, bx]) // 8
            oy, ox = by // k * k, bx // k * k
            inter[by, bx] = inter[oy, ox]
            mv[by, bx] = mv[oy, ox]
    tu = np.minimum(cu, 5).astype(np.int32)
    cbf4 = (rng.random((h64 // 4, w64 // 4)) < 0.4).astype(np.int32)
    return cu, inter, mv, tu, cbf4, h64, w64, rng


@pytest.mark.parametrize("w,h,seed,qp", [(256, 120, 0, 32), (192, 136, 1, 37),
                                          (128, 128, 2, 27)])
def test_bs_maps_and_deblock_match_jax(w, h, seed, qp):
    cu, inter, mv, tu, cbf4, h64, w64, rng = _decisions(w, h, seed)
    bj = jdlf.derive_bs_maps(jnp.asarray(cu), jnp.asarray(inter),
                             jnp.asarray(mv), jnp.asarray(cbf4), w, h,
                             tu_log2_8=jnp.asarray(tu))
    bt = gdlf.derive_bs_maps(T(cu), T(inter), T(mv), T(cbf4), w, h,
                             tu_log2_8=T(tu))
    eq(bt[0], bj[0], "bs_v")
    eq(bt[1], bj[1], "bs_h")
    qpc = chroma_qp(qp, 0, 1)
    rec = [rng.integers(0, 256, s).astype(np.int32)
           for s in ((h64, w64), (h64 // 2, w64 // 2), (h64 // 2, w64 // 2))]
    rec[0][::3] //= 2                       # edges worth filtering
    dj = jdlf.deblock_dev(*(jnp.asarray(r) for r in rec), *bj,
                          jnp.int32(qp), jnp.int32(qpc))
    dt = gdlf.deblock_dev(*(T(r) for r in rec), *bt, qp, qpc)
    for a, b in zip(dj, dt):
        eq(b, a, "deblocked plane")


@pytest.fixture(scope="module")
def sao_inputs():
    """Deblocked-like recon and source at 256x120 (grid 128x256), with
    the validity masks of the coded area."""
    w, h, ctb = 256, 120, 32
    rng = np.random.default_rng(3)
    src = [rng.integers(40, 216, s).astype(np.int32)
           for s in ((128, 256), (64, 128), (64, 128))]
    rec = [np.clip(s + rng.integers(-6, 7, s.shape), 0, 255).astype(np.int32)
           for s in src]
    rec[0][:, :64] = np.clip(src[0][:, :64] + 3, 0, 255)   # a biased band
    valid = []
    for comp, r in enumerate(rec):
        hv, wv = (h, w) if comp == 0 else (h // 2, w // 2)
        hh, ww = r.shape
        valid.append(((np.arange(hh)[:, None] < hv)
                      & (np.arange(ww)[None, :] < wv)).astype(np.float32))
    return w, h, ctb, src, rec, valid


def test_sao_stats_decide_apply_match_jax(sao_inputs):
    w, h, ctb, src, rec, valid = sao_inputs
    lam = float(np.float32(lambda_sse(32)))
    stats_j, stats_t = [], []
    for comp in range(3):
        cell = ctb if comp == 0 else ctb // 2
        sj = jenc.sao_stats_plane(jnp.asarray(rec[comp]),
                                  jnp.asarray(src[comp]),
                                  jnp.asarray(valid[comp]), cell, cell)
        st = genc.sao_stats_plane(T(rec[comp]), T(src[comp]), T(valid[comp]),
                                  cell, cell)
        for k in ("eo_cnt", "eo_sum", "bo_cnt", "bo_sum"):
            eq(st[k], sj[k], f"{k}{comp}")
        stats_j.append(sj)
        stats_t.append(st)
    decide = jax.jit(jsao.sao_decide_dev, static_argnames=("bit_depth",))
    pj = decide(stats_j, jnp.float32(lam))
    pt = gsao.sao_decide_dev(stats_t, lam)
    for k in ("type", "eo", "bp", "offs"):
        eq(pt[k], pj[k], k)
    assert np.asarray(pj["type"]).any()       # some CTBs use SAO
    for comp in range(3):
        wc, hc = (w, h) if comp == 0 else (w // 2, h // 2)
        aj = jsao.sao_apply_dev(jnp.asarray(rec[comp]), pj, comp, ctb, wc, hc)
        at = gsao.sao_apply_dev(T(rec[comp]), pt, comp, ctb, wc, hc)
        eq(at, aj, f"sao applied {comp}")
