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


@pytest.mark.parametrize("bd", [8, 10])
def test_mc_block_batched_matches_fields_jax_and_pallas(bd):
    """Exact: one batched K2 call (K=3 MV fields on one luma plane; Cb and
    Cr, P=2, under each field) == the loop of one-field calls == the JAX
    _mc_luma/_mc_chroma and mc_block_pallas (interpret) field by field, at
    32x64, rounded and 14-bit."""
    rng = np.random.default_rng(100 + bd)
    h, w, k = 32, 64, 3
    pad = tenc.PAD
    lim = (pad - 9) * 4
    mvs = np.stack([_mvs(h, w, bd + i) for i in range(k)])
    ref = rng.integers(0, 1 << bd, (h, w)).astype(np.int32)
    refc = rng.integers(0, 1 << bd, (2, h // 2, w // 2)).astype(np.int32)
    ey_t = genc._ext_y(torch.from_numpy(ref))
    ec_t = genc._ext_c(torch.from_numpy(refc))                # (2, hp, wp)
    ey_j = tenc._ext_y(jnp.asarray(ref))
    ec_j = [tenc._ext_c(jnp.asarray(p)) for p in refc]
    for rounded in (False, True):
        got_y = genc._mc_luma(ey_t, torch.from_numpy(mvs), bd, rounded)
        got_c = genc._mc_chroma(ec_t, torch.from_numpy(mvs), bd, rounded)
        assert got_y.shape == (k, h, w)
        assert got_c.shape == (2, k, h // 2, w // 2)
        for i in range(k):
            mv_j = jnp.asarray(mvs[i])
            np.testing.assert_array_equal(
                got_y[i].numpy(),
                np.asarray(tenc._mc_luma(ey_j, mv_j, bd, rounded)))
            np.testing.assert_array_equal(
                got_y[i].numpy(),
                genc._mc_luma(ey_t, torch.from_numpy(mvs[i]), bd,
                              rounded).numpy())
            mvc = np.clip(mvs[i], -lim, lim)
            mvx, mvy = mvc[..., 0], mvc[..., 1]
            ly = ((mvy >> 2) + pad + 1, (mvx >> 2) + pad + 1, mvx & 3,
                  mvy & 3)
            pal = mc_block_pallas(ey_j, *(jnp.asarray(m) for m in ly), 8, 8,
                                  pad, rounded, bd, True)
            np.testing.assert_array_equal(got_y[i].numpy(), np.asarray(pal))
            for p in range(2):
                np.testing.assert_array_equal(
                    got_c[p, i].numpy(),
                    np.asarray(tenc._mc_chroma(ec_j[p], mv_j, bd, rounded)))
                np.testing.assert_array_equal(
                    got_c[p, i].numpy(),
                    genc._mc_chroma(ec_t[p], torch.from_numpy(mvs[i]), bd,
                                    rounded).numpy())
        # one field on both chroma planes: (2, h/2, w/2)
        one = genc._mc_chroma(ec_t, torch.from_numpy(mvs[0]), bd, rounded)
        np.testing.assert_array_equal(one.numpy(), got_c[:, 0].numpy())


def test_mc_block_refuses_mismatched_shapes():
    """The K2 wrapper (and its plain version) refuse maps that differ in
    shape, maps that do not fit the plane, planes of the wrong rank and
    (n, taps) pairs the kernel has no instance for, on every device."""
    ext = torch.zeros((2, 32 + 2 * 68, 64 + 2 * 68), dtype=torch.int32)
    good = torch.zeros((3, 4, 8), dtype=torch.int32)
    with pytest.raises(ValueError):               # maps differ in shape
        K.mc_block(ext, good, good, good, good[:2], 8, 8, 64, True, 8)
    with pytest.raises(ValueError):               # maps off the block grid
        bad = torch.zeros((3, 5, 8), dtype=torch.int32)
        K.mc_block(ext, bad, bad, bad, bad, 8, 8, 64, True, 8)
    with pytest.raises(ValueError):               # plane rank
        K.mc_block(ext[None], good, good, good, good, 8, 8, 64, True, 8)
    with pytest.raises(ValueError):               # map rank
        m4 = good[None]
        K.mc_block(ext, m4, m4, m4, m4, 8, 8, 64, True, 8)
    with pytest.raises(ValueError):               # no (8, 4) instance
        K.mc_block(ext, good, good, good, good, 8, 4, 64, True, 8)
    with pytest.raises(ValueError):
        K.mc_block_ref(ext, good, good, good, good[:2], 8, 8, 64, True, 8)
    meta = ext.to("meta")
    with pytest.raises(ValueError):
        K.mc_block(meta, good[:2].to("meta"), *(good.to("meta"),) * 3, 8,
                   8, 64, True, 8)
    out = K.mc_block(ext, good, good, good, good, 8, 8, 64, True, 8)
    assert out.shape == (2, 3, 32, 64)


def test_mc_block_filter_tables_match_core_inter():
    """csrc/mc_block.cu keeps the interpolation filters in __constant__
    tables: they equal core.inter's LUMA_FILTERS / CHROMA_FILTERS."""
    import os
    import re

    from svt_hevc_tpu_torch.core.inter import CHROMA_FILTERS, LUMA_FILTERS
    src = open(os.path.join(K.CSRC, "mc_block.cu")).read()

    def table(name):
        body = re.search(name + r"\[[^\]]*\] = \{([^}]*)\}", src).group(1)
        return [int(v) for v in re.findall(r"-?\d+", body)]

    assert table("c_luma") == [int(v) for p in range(4)
                               for v in LUMA_FILTERS[p]]
    assert table("c_chroma") == [int(v) for p in range(8)
                                 for v in CHROMA_FILTERS[p]]


def test_ptxas_summary_reads_registers_smem_and_spills():
    """build_all's nvcc runs ptxas verbosely; ptxas_summary turns its
    report into one line per kernel instance."""
    log = (
        "ptxas info    : 0 bytes gmem, 256 bytes cmem[3]\n"
        "ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_115mc_"
        "block_kernelILi8ELi8ELb1EEEvPKiiiS2_S2_S2_S2_Piiiiiii' for "
        "'sm_90a'\n"
        "ptxas info    : Function properties for _ZN12_GLOBAL__N_115mc_"
        "block_kernelILi8ELi8ELb1EEEvPKiiiS2_S2_S2_S2_Piiiiiii\n"
        "    0 bytes stack frame, 8 bytes spill stores, 4 bytes spill loads\n"
        "ptxas info    : Used 105 registers, used 0 barriers, 33792 bytes "
        "smem, 432 bytes cmem[0]\n"
        "ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_116sad_"
        "field_kernelILi4EEEvPKfS2_Pfii' for 'sm_90a'\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Used 40 registers, 21888 bytes smem\n")
    assert K.ptxas_summary(log) == [
        "mc_block_kernel<8,8,1>: 105 registers, 33792 B smem, 0 B stack, "
        "8 B spill stores, 4 B spill loads",
        "sad_field_kernel<4>: 40 registers, 21888 B smem, 0 B stack, "
        "0 B spill stores, 0 B spill loads"]
    assert K.ptxas_summary("nvcc: no verbose output") == []
