"""The port's float32 analysis helpers against the JAX package's at the
full 1920x1080 size (1920x1088 padded), where the JAX graphs' float32
sums are no longer exact: the per-CTB QP maps and content classes of
sharpness-driven adaptive QP (Encoder._derive_qp_map over a 3-picture
clip of chip_smoke.make_frames(seed=7)), and denoise_plane's noise class,
sigma and filtered plane at 8 and 10 bits on that clip with seeded noise
of standard deviation 0 to 8, and on a clean 1920x1088 ramp (the class
without filtering, which the textured clip never falls in).

Marked slow (Tier-1 runs -m 'not slow'): python -m pytest -m slow
tests/test_torch_fullsize_helpers.py. Tolerance: the QP maps, the
classes, the noise classes and the filtered planes exact; sigma is
host-dependent in the reference (tests/test_torch_float32_sites.py): the
port's equals the exact value rounded once, bit for bit, and the JAX
sigma under each of three compiles lies within its measured spread (up
to 3 float32 ulps at 1080p).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from chip_smoke import make_frames
from svt_hevc_tpu.config import EncoderConfig as JCfg
from svt_hevc_tpu.pipeline.encoder import Encoder as JEncoder
from svt_hevc_tpu.tpu.analysis import denoise_plane as j_denoise
from svt_hevc_tpu_torch import Encoder, EncoderConfig
from svt_hevc_tpu_torch.gpu.analysis import denoise_plane
from tests.test_torch_analysis_helpers import _noise_plane
from tests.test_torch_encoder import one_torch_thread  # noqa: F401
from tests.test_torch_float32_sites import assert_host_dependent, np_sigma

pytestmark = pytest.mark.slow


def test_qp_maps_and_classes_1080p_match_jax():
    kw = dict(width=1920, height=1080, qp=32, intra_period=-1,
              improve_sharpness=True)
    jenc = JEncoder(JCfg(**kw))
    tenc = Encoder(EncoderConfig(**kw), device="cpu")
    for i, f in enumerate(make_frames(3, 1920, 1080, seed=7)):
        want = jenc._derive_qp_map(np.asarray(f.y), 32, frame=f)
        got = tenc._derive_qp_map(np.asarray(f.y), 32, frame=f)
        assert got.shape == (34, 60)
        np.testing.assert_array_equal(got, want, err_msg=f"QP map {i}")
        assert set(tenc.last_classes) == set(jenc.last_classes)
        for k, v in jenc.last_classes.items():
            np.testing.assert_array_equal(tenc.last_classes[k], v,
                                          err_msg=f"class {k} {i}")


def _class(sigma, maxval):
    lo = np.float32(0.004 * maxval)
    hi = np.float32(0.012 * maxval)
    return 0 if sigma < lo else (1 if sigma < hi else 2)


@pytest.mark.parametrize("bd", [8, 10])
def test_denoise_classes_1080p_match_jax(bd):
    maxval = (1 << bd) - 1
    seen = set()
    planes = {f"ramp_{bd}bit_1088x1920":
              _noise_plane(1088, 1920, bd, 0.0, seed=bd)}
    for sd in (0.0, 1.5, 4.0, 8.0):
        f = make_frames(1, 1920, 1080, seed=7, noise=sd, bit_depth=bd)[0]
        for c in ("y", "cb"):
            planes[f"nat_{bd}bit_sd{sd}_1080p_{c}"] = np.asarray(
                getattr(f, c), np.int32)
    for i, (key, p) in enumerate(planes.items()):
        out_j, sig_j = j_denoise(jnp.asarray(p), maxval=maxval)
        out_t, sig_t = denoise_plane(torch.from_numpy(p), maxval=maxval)
        assert_host_dependent(f"sigma/{key}", "fullsize", sig_t.numpy(),
                              np_sigma(p, maxval))
        sig_j, sig_t = float(sig_j), float(sig_t)
        assert _class(sig_t, maxval) == _class(sig_j, maxval), i
        np.testing.assert_array_equal(out_t.numpy(), np.asarray(out_j),
                                      err_msg=f"plane {i}")
        seen.add(_class(sig_t, maxval))
    assert seen == {0, 1, 2}
