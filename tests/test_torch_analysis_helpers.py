"""The host path's device helpers in the port against the JAX package,
on the CPU.

Inputs come from a seed through numpy; each goes through the JAX function
(jitted, as the JAX encoder calls it) and its port twin on CPU tensors.

Tolerances. Exact equality everywhere the JAX graph computes exactly:
the intra search maps and ois_packed, the decimations, dev_me_field
(integer SADs), denoise_plane (planes and sigma, at 8 and 10 bits, in
each of the three noise classes: the residual sum stays below 2^24
units of 1/256 at these sizes, and sigma also equals the exact value),
and block_variance / ctb_activity on blocks whose mean is an integer and
whose deviations stay below 64 (every float32 square and partial sum
exact). On natural content the variances are host-dependent in the
reference: the JAX graph rounds each float32 square and sums in an order
that follows the compiling host's vector ISA
(tests/test_torch_float32_sites.py). There the port's variances and
activities equal the exact values rounded once, bit for bit, the JAX
graph's under each of three compiles lie within their measured spread
of them, and the integer QP maps the encoder derives are equal.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from svt_hevc_tpu.config import EncoderConfig as JCfg
from svt_hevc_tpu.io.yuv import Frame as JFrame
from svt_hevc_tpu.pipeline.encoder import Encoder as JEncoder
from svt_hevc_tpu.pipeline.encoder import tpu_me_field
from svt_hevc_tpu.tpu import analysis as ja
from svt_hevc_tpu_torch import Encoder, EncoderConfig
from svt_hevc_tpu_torch.gpu import analysis as ta
from svt_hevc_tpu_torch.io.yuv import Frame
from svt_hevc_tpu_torch.pipeline.encoder import dev_me_field
from tests.test_torch_encoder import make_frames
from tests.test_torch_encoder import one_torch_thread  # noqa: F401
from tests.test_torch_float32_sites import (assert_host_dependent,
                                            np_block_variance,
                                            np_ctb_activity, np_sigma)

_j_block_variance = jax.jit(ja.block_variance, static_argnums=1)


def _integer_mean_plane(h, w, bd, seed):
    """Blocks whose mean is an integer at every size up to 32x32: one base
    level per 32x32 area, plus deviations +-d in mirrored pairs inside
    each 8x8 block (d up to 20, its range drawn per 32x32 area so the
    activities differ), so the JAX graph's float32 squares and sums are
    all exact."""
    rng = np.random.default_rng(seed)
    hi = (1 << bd) - 1
    gy, gx = np.arange(h // 8)[:, None] // 4, np.arange(w // 8)[None, :] // 4
    base = rng.integers(40, hi - 40, (h // 32 + 1, w // 32 + 1))[gy, gx]
    amp = rng.integers(0, 21, (h // 32 + 1, w // 32 + 1))[gy, gx]
    half = rng.integers(-1, 2, (h // 8, w // 8, 32)).astype(np.int64)
    half *= amp[..., None]
    dev = np.concatenate([half, -half], -1).reshape(h // 8, w // 8, 8, 8)
    y = base[:, :, None, None] + dev
    return y.transpose(0, 2, 1, 3).reshape(h, w).astype(np.int32)


def _natural_plane(h, w, bd, seed):
    y = make_frames(1, w, h, seed=seed)[0][0].astype(np.int32)
    return y << (bd - 8)


@pytest.mark.parametrize("bd", [8, 10])
@pytest.mark.parametrize("n", [8, 16, 32])
def test_block_variance_matches_jax(n, bd):
    y = _integer_mean_plane(64, 128, bd, seed=n + bd)
    got = ta.block_variance(torch.from_numpy(y), n)
    want = np.asarray(_j_block_variance(jnp.asarray(y, jnp.float32), n))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    y = _natural_plane(64, 128, bd, seed=n)
    got = ta.block_variance(torch.from_numpy(y), n).numpy()
    assert_host_dependent(f"bv{n}/helpers_{bd}bit_64x128_s{n}", "helpers",
                          got, np_block_variance(y, n))


@pytest.mark.parametrize("ctb", [32, 64])
def test_ctb_activity_matches_jax(ctb):
    y = _integer_mean_plane(128, 192, 8, seed=ctb)
    got = ta.ctb_activity(torch.from_numpy(y), ctb)
    want = np.asarray(ja.ctb_activity(jnp.asarray(y, jnp.float32), ctb))
    assert got.shape == want.shape == (128 // ctb, 192 // ctb)
    np.testing.assert_array_equal(got.numpy(), want)
    y = _natural_plane(128, 192, 8, seed=ctb)
    got = ta.ctb_activity(torch.from_numpy(y), ctb).numpy()
    assert_host_dependent(f"ctb{ctb}/helpers_8bit_128x192_s{ctb}",
                          "helpers", got, np_ctb_activity(y, ctb))


def test_analyze_frame_and_ois_packed_match_jax():
    y = _natural_plane(128, 192, 8, seed=4)
    got = ta.analyze_frame(torch.from_numpy(y))
    want = ja.analyze_frame(jnp.asarray(y, jnp.float32))
    assert set(got) == set(want)
    for k in want:
        w = np.asarray(want[k])
        assert got[k].shape == w.shape and str(got[k].dtype)[6:] == str(
            w.dtype), k
        if k.startswith("var"):
            n = int(k[3:])
            assert_host_dependent(f"af_var{n}/af_helpers_8bit_128x192_s4",
                                  "helpers", got[k].numpy(),
                                  np_block_variance(y, n))
        else:
            np.testing.assert_array_equal(got[k].numpy(), w, err_msg=k)
    yi = _integer_mean_plane(128, 192, 8, seed=5)
    got = ta.analyze_frame(torch.from_numpy(yi))
    want = ja.analyze_frame(jnp.asarray(yi, jnp.float32))
    for k in ("var8", "var16", "var32"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    for plane in (y, yi):
        got = ta.ois_packed(torch.from_numpy(plane))
        want = np.asarray(ja.ois_packed(jnp.asarray(plane)))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)


def _noise_plane(h, w, bd, sd, seed):
    """A smooth ramp plus Gaussian noise of standard deviation sd (in
    8-bit units, scaled to the bit depth)."""
    rng = np.random.default_rng(seed)
    s = 1 << (bd - 8)
    y = np.tile(np.linspace(30, 220, w), (h, 1)) * s
    y = y + rng.normal(0, sd * s, y.shape)
    return np.clip(np.round(y), 0, (1 << bd) - 1).astype(np.int32)


@pytest.mark.parametrize("bd", [8, 10])
def test_denoise_plane_matches_jax_in_each_noise_class(bd):
    maxval = (1 << bd) - 1
    classes = set()
    for i, sd in enumerate((0.0, 1.0, 2.0, 3.5, 6.0, 9.0)):
        p = _noise_plane(64, 96, bd, sd, seed=10 * bd + i)
        got, gsig = ta.denoise_plane(torch.from_numpy(p), maxval=maxval)
        want, wsig = ja.denoise_plane(jnp.asarray(p, jnp.float32),
                                      maxval=maxval)
        assert gsig.dtype == torch.float32 and gsig.dim() == 0
        assert float(gsig) == float(wsig), sd
        assert float(gsig) == float(np_sigma(p, maxval)), sd
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        s = float(wsig)
        classes.add(0 if s < 0.004 * maxval else 1 if s < 0.012 * maxval
                    else 2)
    assert classes == {0, 1, 2}


@pytest.mark.parametrize("h,w", [(64, 128), (68, 72)])
def test_dev_me_field_matches_tpu_me_field(h, w):
    fr = make_frames(2, w, h, seed=9)
    src, ref = fr[1][0].astype(np.int32), fr[0][0].astype(np.int32)
    got = dev_me_field(src, ref, "cpu")
    want = tpu_me_field(src, ref)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


QPM_CASES = {
    # improve_sharpness with the frame: content classes, over 3 pictures
    # (the stationary-edge class reads the previous picture)
    "sharp_classes": (dict(improve_sharpness=True), True),
    # improve_sharpness without the frame: the dark-area branch
    "sharp_dark": (dict(improve_sharpness=True), False),
    "brr": (dict(bit_rate_reduction=True), True),
    "sharp_brr_ctb64": (dict(improve_sharpness=True, bit_rate_reduction=True,
                             ctb_size=64), True),
}


@pytest.mark.parametrize("case", list(QPM_CASES))
def test_derive_qp_map_matches_jax(case):
    kw, with_frame = QPM_CASES[case]
    w, h = 192, 136
    planes = make_frames(3, w, h, seed=2)
    # a dark band so the dark branch and the dark class both act
    for y, _, _ in planes:
        y[: h // 3] //= 5
    jenc = JEncoder(JCfg(width=w, height=h, qp=30, **kw))
    tenc = Encoder(EncoderConfig(width=w, height=h, qp=30, **kw),
                   device="cpu")
    for y, cb, cr in planes:
        want = jenc._derive_qp_map(y, 30, frame=JFrame(y, cb, cr)
                                   if with_frame else None)
        got = tenc._derive_qp_map(y, 30, frame=Frame(y, cb, cr)
                                  if with_frame else None)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
        if with_frame and kw.get("improve_sharpness"):
            assert set(tenc.last_classes) == set(jenc.last_classes)
            for k, v in jenc.last_classes.items():
                np.testing.assert_array_equal(tenc.last_classes[k], v,
                                              err_msg=k)
            np.testing.assert_array_equal(np.asarray(tenc._prev_src_y),
                                          np.asarray(jenc._prev_src_y))
    assert len(np.unique(got)) > 1
