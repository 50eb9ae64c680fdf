"""The port's hierarchical motion search (svt_hevc_tpu_torch.gpu.me)
against svt_hevc_tpu.tpu.me.hme_search.

Tolerance: exact equality of the MV field and the SAD map. The inputs
are panned textures, so the coarse levels recentre the fine ones and the
flat square produces SAD ties, where both must take the first
displacement in scan order.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from svt_hevc_tpu.tpu.me import _decimate2 as j_decimate2
from svt_hevc_tpu.tpu.me import hme_search as j_hme
from svt_hevc_tpu_torch.gpu.me import _decimate2, hme_search
from tests.test_torch_encoder import make_frames, one_torch_thread  # noqa: F401


def _pad64(p):
    h, w = p.shape
    hh, ww = (h + 63) // 64 * 64, (w + 63) // 64 * 64
    return np.pad(p.astype(np.int32), ((0, hh - h), (0, ww - w)), "edge")


@pytest.mark.parametrize("w,h,shift", [(256, 128, 1), (512, 256, 3)])
def test_hme_search_matches_jax(w, h, shift):
    frames = make_frames(shift + 1, w, h, seed=w)
    src = _pad64(frames[shift][0])
    ref = _pad64(frames[0][0])
    mv_j, sad_j = j_hme(jnp.asarray(src), jnp.asarray(ref))
    mv_t, sad_t = hme_search(torch.from_numpy(src), torch.from_numpy(ref))
    np.testing.assert_array_equal(mv_t.numpy(), np.asarray(mv_j))
    np.testing.assert_array_equal(sad_t.numpy(), np.asarray(sad_j))
    assert np.abs(np.asarray(mv_j)).max() > 0     # the pan was found


def test_decimate2_matches_jax():
    rng = np.random.default_rng(0)
    p = (rng.integers(0, 256 * 4, (64, 128)) / 4).astype(np.float32)
    np.testing.assert_array_equal(
        _decimate2(torch.from_numpy(p)).numpy(),
        np.asarray(j_decimate2(jnp.asarray(p))))
