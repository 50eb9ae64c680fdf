"""The port's kernels (svt_hevc_tpu_torch.gpu.kernels) against the JAX
package: K1's plain version vs me._block_sad_all_disp and the Pallas
sad_field_pallas (interpret mode), K2's plain version vs the XLA direct
MC forms and the Pallas mc_block_pallas (interpret mode).

Tolerance: exact equality everywhere. The JAX package is integer-exact by
design (SAD sums of 1/16-multiples below 2^20 are exact in float32; MC is
int32 arithmetic), and the port must reproduce it bit for bit. On the
CPU the wrappers take the plain versions, so these tests also pin what
the CUDA kernels are compared against on the card (chip_smoke.py).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from svt_hevc_tpu.tpu import encode as tenc
from svt_hevc_tpu.tpu.me import _block_sad_all_disp
from svt_hevc_tpu.tpu.pallas_kernels import mc_block_pallas, sad_field_pallas
from svt_hevc_tpu_torch.gpu import encode as genc
from svt_hevc_tpu_torch.gpu import kernels as K
from tests.test_torch_encoder import one_torch_thread  # noqa: F401


def _planes(shape, frac: bool, seed: int):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, 256 * 16, shape).astype(np.float32)
    ref = rng.integers(0, 256 * 16, shape).astype(np.float32)
    if frac:                       # 1/16 multiples, like HME level 2
        return src / 16, ref / 16
    return np.floor(src / 16), np.floor(ref / 16)


@pytest.mark.parametrize("r", [2, 4, 8])
@pytest.mark.parametrize("frac", [False, True])
def test_sad_field_ref_matches_xla_and_pallas(r, frac):
    """Exact: sad_field_ref == _block_sad_all_disp == sad_field_pallas."""
    src, ref = _planes((32, 128), frac, r + 10 * frac)
    want = np.asarray(_block_sad_all_disp(jnp.asarray(src),
                                          jnp.asarray(ref), 16, r))
    got = K.sad_field_ref(torch.from_numpy(src), torch.from_numpy(ref), 16,
                          r).numpy()
    np.testing.assert_array_equal(got, want)
    pal = np.asarray(sad_field_pallas(jnp.asarray(src), jnp.asarray(ref),
                                      16, r, True))
    np.testing.assert_array_equal(got, pal)
    # the wrapper takes the plain version for CPU tensors
    wrap = K.sad_field(torch.from_numpy(src), torch.from_numpy(ref), 16, r)
    np.testing.assert_array_equal(wrap.numpy(), want)


def _mvs(h, w, seed):
    """MVs over the whole range: random, exactly +-(PAD-9)*4 and beyond
    the clamp."""
    rng = np.random.default_rng(seed)
    lim = (tenc.PAD - 9) * 4
    mv = rng.integers(-lim - 60, lim + 61, (h // 8, w // 8, 2))
    mv[0] = lim
    mv[1] = -lim
    mv[2, :, 0] = lim + 37
    mv[3, :, 1] = -lim - 41
    return mv.astype(np.int32)


@pytest.mark.parametrize("bd", [8, 10])
def test_mc_block_ref_matches_direct_and_pallas(bd):
    """Exact: the port's _mc_luma/_mc_chroma (clamp + K2 wrapper -> plain
    on the CPU) == the JAX _mc_luma/_mc_chroma (clamp + XLA direct form),
    and mc_block_ref == _mc_*_direct == mc_block_pallas (interpret) on
    the clamped maps; luma and chroma, rounded and 14-bit."""
    rng = np.random.default_rng(bd)
    h, w = 32, 32
    pad = tenc.PAD
    lim = (pad - 9) * 4
    mv = _mvs(h, w, bd)
    mvc = np.clip(mv, -lim, lim)
    ref = rng.integers(0, 1 << bd, (h, w)).astype(np.int32)
    refc = rng.integers(0, 1 << bd, (h // 2, w // 2)).astype(np.int32)
    ey_j, ec_j = tenc._ext_y(jnp.asarray(ref)), tenc._ext_c(jnp.asarray(refc))
    ey_t = genc._ext_y(torch.from_numpy(ref))
    ec_t = genc._ext_c(torch.from_numpy(refc))
    np.testing.assert_array_equal(ey_t.numpy(), np.asarray(ey_j))
    np.testing.assert_array_equal(ec_t.numpy(), np.asarray(ec_j))
    mvx, mvy = mvc[..., 0], mvc[..., 1]
    ly = ((mvy >> 2) + pad + 1, (mvx >> 2) + pad + 1, mvx & 3, mvy & 3)
    lc = ((mvy >> 3) + pad // 2 + 1, (mvx >> 3) + pad // 2 + 1, mvx & 7,
          mvy & 7)
    for rounded in (False, True):
        for comp, ej, et, maps, n, taps, p in (
                ("luma", ey_j, ey_t, ly, 8, 8, pad),
                ("chroma", ec_j, ec_t, lc, 4, 4, pad // 2)):
            fj = tenc._mc_luma if comp == "luma" else tenc._mc_chroma
            ft = genc._mc_luma if comp == "luma" else genc._mc_chroma
            want = np.asarray(fj(ej, jnp.asarray(mv), bd, rounded))
            got = ft(et, torch.from_numpy(mv), bd, rounded).numpy()
            np.testing.assert_array_equal(got, want)
            direct = {("luma", False): tenc._mc_raw_luma_direct,
                      ("luma", True): tenc._mc_pred_luma_direct,
                      ("chroma", False): tenc._mc_raw_chroma_direct,
                      ("chroma", True): tenc._mc_pred_chroma_direct}
            want_d = np.asarray(direct[comp, rounded](ej, jnp.asarray(mvc),
                                                      bd))
            plain = K.mc_block_ref(et, *(torch.from_numpy(m) for m in maps),
                                   n, taps, p, rounded, bd).numpy()
            np.testing.assert_array_equal(plain, want_d)
            pal = np.asarray(mc_block_pallas(
                ej, *(jnp.asarray(m) for m in maps), n, taps, p, rounded,
                bd, True))
            np.testing.assert_array_equal(plain, pal)


def test_kernels_import_builds_nothing_and_foreign_devices_raise():
    """Importing the module compiles nothing (no nvcc here), and a tensor
    on neither the CPU nor a CUDA device is refused, never served by the
    plain version."""
    assert all(k._fn is None for k in K.KERNELS)
    meta = torch.empty((32, 64), device="meta")
    with pytest.raises(ValueError):
        K.sad_field(meta, meta, 16, 2)
    ext = torch.empty((32 + 2 * 68, 64 + 2 * 68), dtype=torch.int32,
                      device="meta")
    z = torch.empty((4, 8), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        K.mc_block(ext, z, z, z, z, 8, 8, 64, True, 8)
