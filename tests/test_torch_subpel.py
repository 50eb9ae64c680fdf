"""The staged quarter-pel helpers of the dense search, the port against the
JAX package: _recenter8, _subpel_raw8, _subpel_pred8 and _refine_subpel
(with its half- and quarter-pel offset tables). Nothing in either
package calls them; they are held here so that the port has a twin of
every function of the JAX package.

Inputs are made from a seed with numpy at 128x256: a textured reference
at 8 and 10 bits, its 16 quarter-pel phase planes (the port's
luma_phase_planes, fed to both packages as the same array), and
per-block MV fields whose phases cover all 16 (fy, fx) pairs, with
negative components and blocks that read the padded planes' first and
last rows and columns (the PAD edge). Tolerance: exact equality
(integers).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svt_hevc_tpu.tpu import encode as jenc
from svt_hevc_tpu_torch.gpu import encode as genc
from tests.test_torch_encoder import one_torch_thread  # noqa: F401

H, W = 128, 256
PAD = genc.PAD


def _reference(bd: int, seed: int) -> np.ndarray:
    """An (H, W) plane of smooth texture and noise at bd bits."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float64)
    f = (np.sin(xx / 7.0 + rng.random() * 6) * np.cos(yy / 5.0)
         + 0.5 * np.sin((xx + 2 * yy) / 11.0))
    y = 128 + 80 * f + rng.normal(0, 6, (H, W))
    return np.clip(y * (1 << (bd - 8)), 0, (1 << bd) - 1).astype(np.int32)


def _raw16(ref: np.ndarray, bd: int) -> np.ndarray:
    raw = genc.luma_phase_planes(torch.from_numpy(ref), bit_depth=bd)
    return raw.reshape(16, raw.shape[2], raw.shape[3]).numpy()


def _mv_field(ny: int, nx: int, seed: int, edge: bool = True):
    """Per-block quarter-pel (mvx, mvy): the phases run through all 16
    (fy, fx) pairs, the full-pel parts lie in [-PAD, PAD] (negative
    components included), and with edge the corner blocks read the padded
    planes' first and last rows and columns."""
    rng = np.random.default_rng(seed)
    ph = np.arange(ny * nx).reshape(ny, nx) % 16
    iy = rng.integers(-PAD, PAD + 1, (ny, nx))
    ix = rng.integers(-PAD, PAD + 1, (ny, nx))
    if edge:
        iy[0, :], iy[-1, :] = -PAD, PAD
        ix[:, 0], ix[:, -1] = -PAD, PAD
        ph[0, 0] = ph[-1, -1] = 0
    return ((4 * ix + ph % 4).astype(np.int32),
            (4 * iy + ph // 4).astype(np.int32))


def _eq(got: torch.Tensor, want) -> None:
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("bd", [8, 10])
def test_recenter8_matches_jax(bd):
    ref = _reference(bd, seed=bd)
    ext = np.pad(ref, PAD, mode="edge")
    rng = np.random.default_rng(100 + bd)
    cy = rng.integers(-PAD, PAD + 1, (H // 8, W // 8)).astype(np.int32)
    cx = rng.integers(-PAD, PAD + 1, (H // 8, W // 8)).astype(np.int32)
    cy[0, :], cy[-1, :], cx[:, 0], cx[:, -1] = -PAD, PAD, -PAD, PAD
    want = jenc._recenter8(jnp.asarray(ext), jnp.asarray(cy),
                           jnp.asarray(cx), H, W)
    got = genc._recenter8(torch.from_numpy(ext), torch.from_numpy(cy),
                          torch.from_numpy(cx), H, W)
    _eq(got, want)
    assert (cy < 0).any() and (cx < 0).any()


@pytest.mark.parametrize("bd", [8, 10])
def test_subpel_raw8_and_pred8_match_jax(bd):
    raw16 = _raw16(_reference(bd, seed=bd), bd)
    mvx, mvy = _mv_field(H // 8, W // 8, seed=bd)
    assert len(set(zip((mvy & 3).ravel(), (mvx & 3).ravel()))) == 16
    assert (mvx < 0).any() and (mvy < 0).any()
    j = [jnp.asarray(a) for a in (raw16, mvx, mvy)]
    t = [torch.from_numpy(a) for a in (raw16, mvx, mvy)]
    _eq(genc._subpel_raw8(*t, H, W), jenc._subpel_raw8(*j, H, W))
    _eq(genc._subpel_pred8(*t, H, W, bd), jenc._subpel_pred8(*j, H, W, bd))


def _start(k: int, bd: int, seed: int):
    """A source that is the reference displaced by a block-wise quarter-pel
    motion plus noise, and per-k-block full-pel start MVs around it with
    their SADs."""
    ref = _reference(bd, seed=seed)
    raw16 = _raw16(ref, bd)
    rng = np.random.default_rng(seed + 1)
    tx, ty = _mv_field(H // 8, W // 8, seed=seed + 2, edge=False)
    tx, ty = tx // 8, ty // 8              # true motion within +/-8 pel
    src = genc._subpel_pred8(torch.from_numpy(raw16), torch.from_numpy(tx),
                             torch.from_numpy(ty), H, W, bd).numpy()
    src = np.clip(src + rng.integers(-3, 4, src.shape), 0,
                  (1 << bd) - 1).astype(np.int32)
    sx = (tx[::k // 8, ::k // 8] >> 2) * 4
    sy = (ty[::k // 8, ::k // 8] >> 2) * 4
    # one k-block column at the PAD edge: the candidates pass it
    sx[:, 0] = -4 * PAD
    pred = genc._subpel_pred8(torch.from_numpy(raw16),
                              genc._rep(torch.from_numpy(sx), k // 8),
                              genc._rep(torch.from_numpy(sy), k // 8), H, W,
                              bd)
    best = genc._boxsum((torch.from_numpy(src) - pred).abs(), k).numpy()
    return src, raw16, sx.astype(np.int32), sy.astype(np.int32), best


def _refine_both(src, raw16, mvx, mvy, best, k, bd):
    want = jenc._refine_subpel(*[jnp.asarray(a) for a in
                                 (src, raw16, mvx, mvy, best)], k, bd)
    got = genc._refine_subpel(*[torch.from_numpy(a) for a in
                                (src, raw16, mvx, mvy, best)], k, bd)
    for g, w_ in zip(got, want):
        _eq(g, w_)
    return [g.numpy() for g in got]


@pytest.mark.parametrize("k", [8, 16, 32])
@pytest.mark.parametrize("bd", [8, 10])
def test_refine_subpel_matches_jax(bd, k):
    src, raw16, mvx, mvy, best = _start(k, bd, seed=10 * k + bd)
    gx, gy, gb = _refine_both(src, raw16, mvx, mvy, best, k, bd)
    moved = (gx != mvx) | (gy != mvy)
    assert moved.any() and (gb <= best).all()
    # the winners lie within the two stages' reach (+/-3 quarter-pel)
    assert (np.abs(gx - mvx) <= 3).all() and (np.abs(gy - mvy) <= 3).all()


@pytest.mark.parametrize("k", [8, 16, 32])
def test_refine_subpel_ties_keep_the_earlier_candidate(k):
    """A flat reference and a flat source: every candidate's SAD ties.
    From an unbeatable start nothing moves; from a start every candidate
    beats, the first half-pel offset (-2, -2) wins and no quarter-pel
    candidate around it replaces it (a <= update would end on (+3, +3):
    the last quarter-pel offset around the last half-pel one)."""
    bd = 8
    raw16 = _raw16(np.full((H, W), 90, np.int32), bd)
    src = np.full((H, W), 100, np.int32)
    rng = np.random.default_rng(k)
    mvx = (4 * rng.integers(-8, 9, (H // k, W // k))).astype(np.int32)
    mvy = (4 * rng.integers(-8, 9, (H // k, W // k))).astype(np.int32)
    tie = np.full((H // k, W // k), 10 * k * k, np.int32)
    gx, gy, gb = _refine_both(src, raw16, mvx, mvy, tie, k, bd)
    np.testing.assert_array_equal(gx, mvx)
    np.testing.assert_array_equal(gy, mvy)
    np.testing.assert_array_equal(gb, tie)
    gx, gy, gb = _refine_both(src, raw16, mvx, mvy, tie + 1, k, bd)
    np.testing.assert_array_equal(gx, mvx - 2)
    np.testing.assert_array_equal(gy, mvy - 2)
    np.testing.assert_array_equal(gb, tie)
