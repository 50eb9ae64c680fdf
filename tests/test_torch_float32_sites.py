"""The float32 sites where the port and the JAX package could round apart,
held under three compiles of the JAX graphs.

XLA:CPU compiles a float32 reduction for the host's vector ISA: a large
reduce becomes 32x32 reduce-windows whose inner order is vectorized with
the ISA's width, then smaller reduces of the window sums. So where such
a sum rounds, the JAX package's value depends on the host that compiled
the graph (and on whoever filled its persistent compile cache). Each
site is measured here under three fresh compiles (the compile cache
off): the host's default ISA, --xla_cpu_max_isa=AVX2 and
--xla_cpu_max_isa=SSE4_2, each in a subprocess (jax_values).

- State 1, ISA-independent: the port reproduces XLA's order and equals
  the JAX value under every compile: the lookahead's zz_sad and gm_sad
  (exact 32x32 window sums, then XLA's row-major chain over the windows,
  gpu.kernels.ordered_sum), the mesh's frontend total, SSE sums whose
  32x32 quarters stay below 2^24, the 10-bit SAO gains.
- State 2, ISA-dependent ("host-dependent in the reference"): the port
  keeps the exact value, rounded once to float32; the test holds it bit
  for bit against a float64 numpy reference rounded once, and each JAX
  value within SPREAD_ULPS float32 ulps of it (per compile and input,
  measured by --table on an AVX-512 host, on the inputs below).
- State 3, ISA-dependent arithmetic: a product feeding an add
  (contracted or not) and a 2x2 window sum (row by row or pairwise); the
  port keeps the AVX-512 compile's arithmetic, and each compile computes
  one of the two (tests/test_torch_fma.py holds the port to recorded
  outputs of that compile, and names each compile's model with the
  probes xla_contracts_multiply_add and xla_sums_2x2_row_by_row).

Inputs: the sizes the other tests use, and 1080p planes (natural content
of chip_smoke.make_frames at 8 and 10 bits, with a scene cut so the
lookahead SADs pass 2^24 sixteenths; integer-mean planes; noisy planes
for the denoiser), so every sum crosses 2^24 somewhere.

    python tests/test_torch_float32_sites.py --table

prints every site's value under the three compiles and its state.
"""

import argparse
import functools
import json
import os
import subprocess
import sys
import tempfile

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

ISAS = {"default": "", "avx2": "--xla_cpu_max_isa=AVX2",
        "sse4_2": "--xla_cpu_max_isa=SSE4_2"}
WORKER_TIMEOUT_S = 600
UHD_WORKER_TIMEOUT_S = 3600


# ------------------------------------------------------------- inputs

def _frames(n, w, h, seed, **kw):
    from chip_smoke import make_frames
    return make_frames(n, w, h, seed=seed, **kw)


def _integer_mean_plane(h, w, bd, seed):
    from tests.test_torch_analysis_helpers import _integer_mean_plane
    return _integer_mean_plane(h, w, bd, seed)


def _natural_plane(h, w, bd, seed):
    from tests.test_torch_analysis_helpers import _natural_plane
    return _natural_plane(h, w, bd, seed)


def _noise_plane(h, w, bd, sd, seed):
    from tests.test_torch_analysis_helpers import _noise_plane
    return _noise_plane(h, w, bd, sd, seed)


def _rc_lumas(bd, t, h, w, seed):
    from tests.test_torch_rc import _lumas
    return _lumas(bd, t, h, w, seed)


def vbr_first_batch(name: str) -> np.ndarray:
    """The lookahead's first batch in a VBR stream of
    tests/test_torch_rc.py (STREAMS[name]): the first picture, then the
    2 (la + 1) pictures of the batch, as Encoder._la_complexities stacks
    them; its variance[0] is the IDR's complexity proxy."""
    from svt_hevc_tpu_torch.io.yuv import Frame
    from tests.test_torch_rc import STREAMS, _frames
    kw, n = STREAMS[name]
    la = kw["look_ahead_distance"]
    ys = [np.asarray(f.y, np.int32) for f in _frames(n, Frame)]
    ys = ys[:2 * (la + 1)]
    return np.stack([ys[0]] + ys)


# lookahead lumas whose grid of 32x32 SAD windows XLA reduces in two
# levels (more than 32 windows on an axis: a luma axis past 4096) or over
# row lanes (a narrow grid: 480x720's 4 x 6)
WIDE_LA = ((1088, 4224), (4224, 1088), (64, 8192), (480, 720))


def wide_la_lumas(h, w, bd, cut) -> np.ndarray:
    """T = 2 lumas: a noisy texture panned by (2, -3) pixels, or followed
    by a scene cut to a brighter picture, so the SADs pass 2^24
    sixteenths."""
    rng = np.random.default_rng(h + w + bd)
    hi = 1 << bd
    base = rng.integers(0, hi, (h + 8, w + 8))
    y0 = base[2:h + 2, :w]
    if cut:
        y1 = rng.integers(3 * hi // 4, hi, (h, w))
    else:
        y1 = base[:h, 3:w + 3] + rng.integers(0, 5, (h, w))
    return np.clip(np.stack([y0, y1]), 0, hi - 1).astype(np.int32)


@functools.lru_cache(maxsize=None)
def la_inputs() -> dict:
    """(T, H, W) int32 luma runs for lookahead_stats: those of
    tests/test_torch_rc.py, 1080p runs past 2^24, and WIDE_LA's."""
    out = {f"rc_{bd}_{t}_{h}x{w}": _rc_lumas(bd, t, h, w, seed=bd + t)
           for bd, t, h, w in ((8, 6, 64, 128), (10, 5, 128, 256),
                               (8, 2, 32, 48))}
    # test_la_complexities_match_jax's stack without a predecessor
    ys = list(_rc_lumas(8, 7, 64, 128, seed=3))
    out["rc_complexities"] = np.stack([ys[1]] + ys[1:])
    for name in ("vbr_la8_x10", "cbr_hier2_filler_x8"):
        out[f"rc_{name}"] = vbr_first_batch(name)
    for bd in (8, 10):
        pan = _frames(2, 1920, 1080, 7, bit_depth=bd)
        cut = _frames(1, 1920, 1080, 8, bit_depth=bd)
        # two pictures of a pan, then a scene cut: SADs on both sides of
        # 2^24 sixteenths
        out[f"1080p_{bd}bit_cut"] = np.stack(
            [np.asarray(f.y, np.int32) for f in pan + cut])
    # a lookahead batch of ten 10-bit pictures, each a cut (uniform noise)
    out["batch10_10bit_544x960"] = np.random.default_rng(9).integers(
        0, 1024, (10, 544, 960)).astype(np.int32)
    for h, w in WIDE_LA:
        for bd in (8, 10):
            for cut in (False, True):
                out[f"wide_{bd}bit_{'cut' if cut else 'pan'}_{h}x{w}"] = \
                    wide_la_lumas(h, w, bd, cut)
    return out


@functools.lru_cache(maxsize=None)
def plane_inputs() -> dict:
    """(H, W) int32 planes for block_variance / ctb_activity (and, where
    a key starts with "af_", analyze_frame): the natural planes of
    tests/test_torch_analysis_helpers.py and tests/test_torch_parallel.py,
    and 1080p planes."""
    out = {}
    for bd in (8, 10):
        for n in (8, 16, 32):
            out[f"helpers_{bd}bit_64x128_s{n}"] = _natural_plane(64, 128, bd,
                                                                 seed=n)
        y = np.asarray(_frames(1, 1920, 1088, 7, bit_depth=bd)[0].y,
                       np.int32)
        out[f"nat_{bd}bit_1088x1920"] = y
        out[f"int_{bd}bit_1088x1920"] = _integer_mean_plane(1088, 1920, bd,
                                                            seed=bd)
    for seed in (32, 64):
        out[f"helpers_8bit_128x192_s{seed}"] = _natural_plane(128, 192, 8,
                                                              seed=seed)
    out["af_helpers_8bit_128x192_s4"] = _natural_plane(128, 192, 8, seed=4)
    for i, f in enumerate(frontend_inputs()["parallel_test"]):
        out[f"af_frontend_{i}"] = f
    return out


@functools.lru_cache(maxsize=None)
def denoise_inputs() -> dict:
    """(plane, maxval) for denoise_plane: those of
    tests/test_torch_analysis_helpers.py and of the slow
    tests/test_torch_fullsize_helpers.py."""
    out = {}
    for bd in (8, 10):
        mx = (1 << bd) - 1
        for i, sd in enumerate((0.0, 1.0, 2.0, 3.5, 6.0, 9.0)):
            out[f"ramp_{bd}bit_sd{sd}_64x96"] = (
                _noise_plane(64, 96, bd, sd, seed=10 * bd + i), mx)
        out[f"ramp_{bd}bit_1088x1920"] = (_noise_plane(1088, 1920, bd, 0.0,
                                                       seed=bd), mx)
        for sd in (0.0, 1.5, 4.0, 8.0):
            f = _frames(1, 1920, 1080, 7, noise=sd, bit_depth=bd)[0]
            for c in ("y", "cb"):
                out[f"nat_{bd}bit_sd{sd}_1080p_{c}"] = (
                    np.asarray(getattr(f, c), np.int32), mx)
    return out


# squared-error planes: e_max 130 gives 64x64 sums past 2^24 with exact
# 32x32 partials (seed 4: three of the four 64x64 sums round apart in
# XLA's order and exactly), 255 32x32 partials past 2^24 too
SSE_CASES = {130: 4, 255: 255}


def sse_input(e_max: int) -> np.ndarray:
    """A 128x128 plane of squared integer errors in [0, e_max]."""
    e = np.random.default_rng(SSE_CASES[e_max]).integers(0, e_max + 1,
                                                         (128, 128))
    return (e * e).astype(np.int32)


def frontend_inputs() -> dict:
    """Batches of 4 pictures for the mesh's frontend step (gop 2 x tile
    2 on the 8 JAX devices, as tests/test_torch_parallel.py runs it)."""
    from tests.test_torch_parallel import _inputs
    rng = np.random.default_rng(6)
    return {"parallel_test": _inputs("frontend", 2),
            "seed6_256": rng.integers(0, 256, (4, 128, 256)).astype(
                np.int32)}


# The UHD input set (3840x2160 and 7680x4320, natural content of
# chip_smoke.make_frames at 8 and 10 bits), read only by --table and the
# slow tests/test_torch_parity_uhd.py: a 4320p lookahead batch takes
# seconds and gigabytes in each compile's worker
UHD_SIZES = ((3840, 2160), (7680, 4320))
UHD_LA = tuple(f"uhd_{h}p_{bd}bit_cut" for _, h in UHD_SIZES
               for bd in (8, 10))
UHD_DENOISE = tuple(f"uhd_{kind}_{bd}bit_{h}p" for _, h in UHD_SIZES
                    for bd in (8, 10)
                    for kind in ("ramp", "nat_sd1.5", "nat_sd4.0"))
UHD_PLANE = tuple(f"af_uhd_nat_{bd}bit_2176x3840" for bd in (8, 10))
UHD_FRONTEND = ("uhd_4x2176x3840",)
UHD_GROUP = UHD_LA + UHD_DENOISE + UHD_PLANE + UHD_FRONTEND


@functools.lru_cache(maxsize=None)
def uhd_inputs() -> dict:
    """{kind: {name: input}} of the UHD set: lookahead runs (two pictures
    of a pan, then a scene cut) at 2160p and 4320p; denoise_plane's
    near-flat ramp (whose flat count passes 2^24 at 4320p) and natural
    lumas with noise of sd 1.5 and 4.0; analyze_frame / block_variance /
    ctb_activity planes at 2160p (2176 rows: a multiple of 64); the
    mesh frontend's four pictures at 2160p, whose cost total passes
    2^24."""
    out = {"la": {}, "denoise": {}, "plane": {}, "frontend": {}}
    for w, h in UHD_SIZES:
        for bd in (8, 10):
            mx = (1 << bd) - 1
            pan = _frames(2, w, h, 7, bit_depth=bd)
            cut = _frames(1, w, h, 8, bit_depth=bd)
            out["la"][f"uhd_{h}p_{bd}bit_cut"] = np.stack(
                [np.asarray(f.y, np.int32) for f in pan + cut])
            out["denoise"][f"uhd_ramp_{bd}bit_{h}p"] = (
                _noise_plane(h, w, bd, 0.0, seed=bd), mx)
            for sd in (1.5, 4.0):
                f = _frames(1, w, h, 7, noise=sd, bit_depth=bd)[0]
                out["denoise"][f"uhd_nat_sd{sd}_{bd}bit_{h}p"] = (
                    np.asarray(f.y, np.int32), mx)
    for bd in (8, 10):
        out["plane"][f"af_uhd_nat_{bd}bit_2176x3840"] = np.asarray(
            _frames(1, 3840, 2176, 7, bit_depth=bd)[0].y, np.int32)
    out["frontend"]["uhd_4x2176x3840"] = np.stack(
        [np.asarray(f.y, np.int32) for f in _frames(4, 3840, 2176, 9)])
    return out


def inputs_of(kind: str, names=None) -> dict:
    """The inputs of one kind ("la", "plane", "denoise", "frontend"): every
    regular one, or the named ones (UHD_GROUP's included)."""
    regular = {"la": la_inputs, "plane": plane_inputs,
               "denoise": denoise_inputs, "frontend": frontend_inputs}[kind]
    if names is None:
        return regular()
    names = set(names)
    out = {k: v for k, v in regular().items() if k in names}
    if names & set(UHD_GROUP):
        out.update((k, v) for k, v in uhd_inputs()[kind].items()
                   if k in names)
    return out


def fma_input():
    """a + b * c operands whose product is no float32 integer."""
    rng = np.random.default_rng(27)
    a = (rng.random(4096) * 1e6).astype(np.float32)
    c = (rng.random(4096) * 300).astype(np.float32)
    return a, np.float32(34.471443), c


def box2_input():
    """A plane of non-integer float32 costs for 2x2 window sums."""
    rng = np.random.default_rng(28)
    return (rng.random((64, 96)) * 10.0 ** rng.integers(1, 5, (64, 96))
            ).astype(np.float32)


# The arithmetic models of each state-3 value, the port's first: a
# float32 product feeding an add, contracted into one multiply-add or
# rounded twice; a float32 sum over a 2x2 window, row by row or pairwise;
# a 2160p lookahead SAD's grid reduced row by row or over 8 or 4 row
# lanes (la_sad_models)
def _models(key: str) -> dict:
    if key.startswith("la/"):
        return la_sad_models(key)
    if key.startswith("fma/"):
        a, b, c = fma_input()
        return {"fused": (a.astype(np.float64) + np.float64(b) * c).astype(
                    np.float32),
                "two roundings": a + b * c}
    m = box2_input()
    a00, a01, a10, a11 = m[0::2, 0::2], m[0::2, 1::2], m[1::2, 0::2], \
        m[1::2, 1::2]
    return {"row by row": ((a00 + a01) + a10) + a11,
            "pairwise": (a00 + a01) + (a10 + a11)}


def xla_contracts_multiply_add() -> bool:
    """Whether this process's XLA compile contracts a float32 product and
    the add it feeds into one multiply-add, as the default (AVX-512) and
    AVX2 compiles do and the SSE4_2 one does not."""
    import jax
    a, b, c = fma_input()
    got = np.asarray(jax.jit(lambda a, b, c: a + b * c)(a, b, c))
    return np.array_equal(got, _models("fma/xla")["fused"])


def xla_sums_2x2_row_by_row() -> bool:
    """Whether this process's XLA compile sums a float32 2x2 window row by
    row, ((a00 + a01) + a10) + a11, as the default (AVX-512) compile does
    and the AVX2 and SSE4_2 ones (pairwise) do not."""
    import jax
    from svt_hevc_tpu.tpu import encode as je
    got = np.asarray(jax.jit(je._boxsum, static_argnums=1)(box2_input(), 2))
    return np.array_equal(got, _models("box2/xla")["row by row"])


def sao_input(seed: int):
    """Edge-offset statistics of 10-bit 64x64 CTBs (counts, sums) whose
    offsets clip at the 10-bit range and whose 2 o s passes 2^24."""
    rng = np.random.default_rng(seed)
    cnt = rng.integers(0, 4097, (4, 6, 4, 5)).astype(np.int64)
    sums = (cnt * rng.integers(-120, 121, cnt.shape)).astype(np.int64)
    return cnt, sums


# ------------------------------------------------------- the JAX side

def _jax_site_values(inputs=None) -> dict:
    """Every site's JAX value on every input (or on the named inputs
    only), in this process's compile."""
    import jax
    import jax.numpy as jnp

    from svt_hevc_tpu.tpu import analysis as ja
    from svt_hevc_tpu.tpu import encode as je
    from svt_hevc_tpu.tpu import sao as js

    out = {}
    la = jax.jit(ja.lookahead_stats)
    def want(k):
        return inputs is None or k in inputs

    for k, ys in inputs_of("la", inputs).items():
        r = la(jnp.asarray(ys))
        for f in ("variance", "zz_sad", "gm_sad"):
            out[f"la/{k}/{f}"] = np.asarray(r[f])
    bv = jax.jit(ja.block_variance, static_argnums=1)
    for k, y in inputs_of("plane", inputs).items():
        yf = jnp.asarray(y, jnp.float32)
        for n in (8, 16, 32):
            out[f"bv{n}/{k}"] = np.asarray(bv(yf, n))
        for c in (32, 64):
            out[f"ctb{c}/{k}"] = np.asarray(ja.ctb_activity(yf, c))
        if k.startswith("af_"):
            a = ja.analyze_frame(yf)
            for n in (8, 16, 32):
                out[f"af_var{n}/{k}"] = np.asarray(a[f"var{n}"])
    for k, (p, mx) in inputs_of("denoise", inputs).items():
        out[f"sigma/{k}"] = np.asarray(ja.denoise_plane(jnp.asarray(p),
                                                        maxval=mx)[1])
    box = jax.jit(je._boxsum, static_argnums=1)
    for e_max in SSE_CASES:
        for s in (32, 64):
            if not want(f"e{e_max}"):
                continue
            out[f"sse{s}/e{e_max}"] = np.asarray(
                box(jnp.asarray(sse_input(e_max), jnp.float32), s))
    eo = jax.jit(js._eo_offsets_gains, static_argnums=2)
    if want("xla"):
        a, b, c = fma_input()
        out["fma/xla"] = np.asarray(jax.jit(lambda a, b, c: a + b * c)(
            a, b, c))
        out["box2/xla"] = np.asarray(box(jnp.asarray(box2_input()), 2))
    cnt, sums = sao_input(seed=1)
    if want("10bit"):
        out["sao_eo_gain/10bit"] = np.asarray(eo(jnp.asarray(cnt),
                                                 jnp.asarray(sums), 31)[1])
    if len(jax.devices()) >= 8:
        from svt_hevc_tpu.parallel import frontend_step, make_mesh
        from tests.test_torch_parallel import WORLD
        step, in_sh = frontend_step(make_mesh(WORLD))
        for k, frames in inputs_of("frontend", inputs).items():
            out[f"frontend_total/{k}"] = np.asarray(step(jax.device_put(
                jnp.asarray(frames, jnp.float32), in_sh))[1])
    return out


def _worker(path: str, inputs=None) -> None:
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax
    jax.config.update("jax_platforms", "cpu")
    np.savez(path, **_jax_site_values(inputs))


def jax_env(isa: str) -> dict:
    """The environment of one fresh compile of the JAX graphs: the compile
    cache off, XLA's ISA capped as ISAS says and the 8 virtual devices of
    tests/conftest.py."""
    flags = " ".join(f for f in ("--xla_force_host_platform_device_count=8",
                                 ISAS[isa]) if f)
    return dict(os.environ, JAX_COMPILATION_CACHE_DIR="", XLA_FLAGS=flags,
                JAX_PLATFORMS="cpu")


def run_worker(script: str, isa: str, args=(),
               timeout: float = WORKER_TIMEOUT_S) -> dict:
    """The arrays that `python script --worker OUT.npz *args` saves when
    run in a subprocess under jax_env(isa)."""
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "values.npz")
        r = subprocess.run([sys.executable, script, "--worker", path, *args],
                           env=jax_env(isa), cwd=ROOT, capture_output=True,
                           text=True, timeout=timeout)
        assert r.returncode == 0, r.stderr[-3000:]
        with np.load(path) as z:
            return {k: z[k] for k in z.files}


@functools.lru_cache(maxsize=None)
def jax_values(isa: str, inputs: tuple | None = None) -> dict:
    """The JAX values under one fresh compile (of every input, or of the
    named inputs), computed in a subprocess under jax_env(isa)."""
    args = () if inputs is None else ("--inputs", ",".join(inputs))
    uhd = inputs is not None and bool(set(inputs) & set(UHD_GROUP))
    return run_worker(os.path.abspath(__file__), isa, args,
                      UHD_WORKER_TIMEOUT_S if uhd else WORKER_TIMEOUT_S)


# ------------------------------------------------------ the port side

def port_site_values(inputs=None) -> dict:
    """The port's value of every site on every input, or on the named
    inputs only (CPU tensors). The frontend total is frontend_step's rule
    on one rank: the float64 sum of analyze_frame's cost maps, rounded
    to float32 once (tests/test_torch_parallel.py holds the step itself
    on 4 ranks)."""
    from svt_hevc_tpu_torch.gpu import analysis as ta
    from svt_hevc_tpu_torch.gpu import encode as te
    from svt_hevc_tpu_torch.gpu import sao as ts

    out = {}
    for k, ys in inputs_of("la", inputs).items():
        r = ta.lookahead_stats(torch.from_numpy(ys))
        for f in ("variance", "zz_sad", "gm_sad"):
            out[f"la/{k}/{f}"] = r[f].numpy()
    for k, y in inputs_of("plane", inputs).items():
        yt = torch.from_numpy(y)
        for n in (8, 16, 32):
            out[f"bv{n}/{k}"] = ta.block_variance(yt, n).numpy()
        for c in (32, 64):
            out[f"ctb{c}/{k}"] = ta.ctb_activity(yt, c).numpy()
        if k.startswith("af_"):
            a = ta.analyze_frame(yt)
            for n in (8, 16, 32):
                out[f"af_var{n}/{k}"] = a[f"var{n}"].numpy()
    for k, (p, mx) in inputs_of("denoise", inputs).items():
        out[f"sigma/{k}"] = ta.denoise_plane(torch.from_numpy(p),
                                             maxval=mx)[1].numpy()
    for k, frames in inputs_of("frontend", inputs).items():
        tot = 0.0
        for f in frames:
            a = ta.analyze_frame(torch.from_numpy(f))
            tot += sum(float(a[f"cost{n}"].to(torch.float64).sum())
                       for n in (4, 8, 16, 32))
        out[f"frontend_total/{k}"] = np.float32(tot)
    if inputs is not None:
        return out
    for e_max in SSE_CASES:
        for s in (32, 64):
            out[f"sse{s}/e{e_max}"] = te._isum_box_f32(
                torch.from_numpy(sse_input(e_max)), s).numpy()
    a, b, c = fma_input()
    out["fma/xla"] = te._fma(float(b), torch.from_numpy(c),
                             torch.from_numpy(a)).numpy()
    out["box2/xla"] = te._boxsum(torch.from_numpy(box2_input()), 2).numpy()
    cnt, sums = sao_input(seed=1)
    out["sao_eo_gain/10bit"] = ts._eo_offsets_gains(
        torch.from_numpy(cnt), torch.from_numpy(sums), 31)[1].numpy()
    return out


# ------------------------------------------- float64 references, numpy

def np_variance(ys: np.ndarray) -> np.ndarray:
    """Each plane's variance from its exact integer moments in float64,
    rounded to float32 once (the operations of exact_variance_f32)."""
    y = ys.astype(np.int64)
    n = y.shape[-1] * y.shape[-2]
    s = y.sum((-2, -1))
    q = s // n
    d = y - q[..., None, None]
    t = (d * d).sum((-2, -1))
    m = (s - q * n).astype(np.float64) / n
    return (t.astype(np.float64) / n - m * m).astype(np.float32)


def np_block_variance(y: np.ndarray, n: int) -> np.ndarray:
    """Each n x n block's variance: exact int64 squared deviations in
    1/(n n)^2 units, over (n n)^3 in float64, rounded to float32 once."""
    h, w = y.shape
    b = y.astype(np.int64).reshape(h // n, n, w // n, n).transpose(0, 2, 1,
                                                                  3)
    dev = b * (n * n) - b.sum((-2, -1), keepdims=True)
    ss = (dev * dev).sum((-2, -1))
    return (ss.astype(np.float64) / float((n * n) ** 3)).astype(np.float32)


def np_ctb_activity(y: np.ndarray, ctb: int) -> np.ndarray:
    v8 = np_block_variance(y, 8).astype(np.float64)
    k = ctb // 8
    h8, w8 = v8.shape
    s = v8.reshape(h8 // k, k, w8 // k, k).sum((1, 3))
    return (s / float(k * k)).astype(np.float32)


def np_sigma(p: np.ndarray, maxval: int) -> np.float32:
    """denoise_plane's sigma exactly: the flat pixels' |y - blur(y)| summed
    exactly (float64 holds the blur and its 1/256 steps), over the flat
    count + 1, rounded to float32 once."""
    y = p.astype(np.float64)
    k = np.array([1.0, 4.0, 6.0, 4.0, 1.0]) / 16.0
    e = np.pad(y, ((2, 2), (0, 0)), mode="edge")
    b = sum(k[i] * e[i:i + y.shape[0]] for i in range(5))
    e = np.pad(b, ((0, 0), (2, 2)), mode="edge")
    weak = sum(k[i] * e[:, i:i + y.shape[1]] for i in range(5))
    gx = np.abs(np.diff(y, axis=1, prepend=y[:, :1]))
    gy = np.abs(np.diff(y, axis=0, prepend=y[:1, :]))
    flat = (gx + gy) < float(np.float32(0.06 * maxval))
    units = int((np.abs(y - weak)[flat] * 256.0).astype(np.int64).sum())
    return np.float32(units / 256.0 / (flat.sum() + 1.0))


def np_sse(sq: np.ndarray, s: int) -> np.ndarray:
    h, w = sq.shape
    return sq.astype(np.int64).reshape(h // s, s, w // s, s).sum(
        (1, 3)).astype(np.float32)


def exact_site_values(inputs=None) -> dict:
    """The float64 reference, rounded once, of every host-dependent site
    (on every input, or on the named inputs only)."""
    out = {}
    for k, ys in inputs_of("la", inputs).items():
        out[f"la/{k}/variance"] = np_variance(ys)[1:]
    for k, y in inputs_of("plane", inputs).items():
        for n in (8, 16, 32):
            out[f"bv{n}/{k}"] = np_block_variance(y, n)
            if k.startswith("af_"):
                out[f"af_var{n}/{k}"] = out[f"bv{n}/{k}"]
        for c in (32, 64):
            out[f"ctb{c}/{k}"] = np_ctb_activity(y, c)
    for k, (p, mx) in inputs_of("denoise", inputs).items():
        out[f"sigma/{k}"] = np_sigma(p, mx)
    if inputs is None:
        for s in (32, 64):
            out[f"sse{s}/e255"] = np_sse(sse_input(255), s)
    return out


# The sites, each with its value keys' prefix and its state: 1 = the
# same under every compile, and the port equals JAX; 2 = host-dependent
# in the reference, the port exact (rounded once) and JAX within the
# measured spread; 3 = host-dependent arithmetic in the reference: the
# port keeps the arithmetic of the default compile on an AVX-512 host
# (the one that made the BD artifacts and chip_smoke.JAX_1080P), and each
# JAX compile computes one of the two models of _models
SITES = {
    "lookahead_sads": (("la/", "/zz_sad", "/gm_sad"), 1),
    "lookahead_variance": (("la/", "/variance"), 2),
    "block_variance": (("bv",), 2),
    "ctb_activity": (("ctb",), 2),
    "analyze_frame_var": (("af_var",), 2),
    "denoise_sigma": (("sigma/",), 2),
    "sse_exact_quarters": (("sse", "/e130"), 1),
    "sse_quarters_past_2_24": (("sse", "/e255"), 2),
    "sao_gain_10bit": (("sao_eo_gain/",), 1),
    "frontend_total": (("frontend_total/",), 1),
    "fma_contraction": (("fma/",), 3),
    "split_2x2_sum": (("box2/",), 3),
}


def site_of(key: str) -> str:
    """The site a value key belongs to."""
    for site, ((head, *tails), _) in SITES.items():
        if key.startswith(head) and (not tails
                                     or any(key.endswith(t) for t in tails)):
            return site
    raise KeyError(key)


def site_keys(site: str, keys) -> list:
    return sorted(k for k in keys if site_of(k) == site)


def uhd_la_sads_2160p(key: str) -> bool:
    """Whether key is a lookahead SAD of the UHD set at 2160p, whose grid
    of window sums (17 x 30) the reference compile reduces row by row and
    the AVX2 and SSE4_2 compiles over 8 and 4 row lanes (ROADMAP §3): a
    state-3 value."""
    return key.startswith("la/uhd_2160p") and not key.endswith("/variance")


# The reference compile's 2160p lookahead SADs of the UHD set (state 3),
# as float32 bits: the default compile of an AVX-512 host, the compile
# cache off (--table --set uhd, which found the port's values equal)
UHD_LA_RECORDS = {
    "la/uhd_2160p_8bit_cut/zz_sad": (0x40E3DC8C, 0x41311B51),
    "la/uhd_2160p_8bit_cut/gm_sad": (0x40E39BA9, 0x4130AD23),
    "la/uhd_2160p_10bit_cut/zz_sad": (0x41E3E12E, 0x42311C4A),
    "la/uhd_2160p_10bit_cut/gm_sad": (0x41E39E73, 0x4230AECB),
}


def state_of(key: str) -> int:
    """The state of the value key (SITES; 3 for uhd_la_sads_2160p)."""
    return 3 if uhd_la_sads_2160p(key) else SITES[site_of(key)][1]


def la_sad_models(key: str) -> dict:
    """The models of a state-3 lookahead SAD (uhd_la_sads_2160p): the
    port's value under the reference compile's plan, then under the same
    plan with 8 and with 4 row lanes."""
    from svt_hevc_tpu_torch.gpu import analysis as ta
    _, name, field = key.split("/")
    ys = torch.from_numpy(uhd_inputs()["la"][name])
    plan = ta.xla_reduce_plan
    out = {}
    for label, lanes in (("reference", None), ("lanes 8", 8),
                         ("lanes 4", 4)):
        if lanes is not None:
            ta.xla_reduce_plan = (lambda gh, gw, n=lanes:
                                  plan(gh, gw)._replace(lanes=n))
        try:
            out[label] = ta.lookahead_stats(ys)[field].numpy()
        finally:
            ta.xla_reduce_plan = plan
    return out


def ulps(a, b) -> int:
    """The largest distance in float32 ulps between a and b (same sign)."""
    ia = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    ib = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return int(np.abs(ia - ib).max()) if ia.size else 0


def _table(which: str = "all") -> None:
    """Print every value's measurements, then SPREAD_ULPS: which is
    "regular" (the inputs the tests read), "uhd" (UHD_GROUP) or "all"."""
    sets = {"regular": [None], "uhd": [UHD_GROUP],
            "all": [None, UHD_GROUP]}[which]
    vals = {isa: {} for isa in ISAS}
    port, exact = {}, {}
    for names in sets:
        for isa in ISAS:
            vals[isa].update(jax_values(isa, names))
        port.update(port_site_values(names))
        exact.update(exact_site_values(names))
    spreads = {}
    for k in sorted(vals["default"], key=lambda k: (site_of(k), k)):
        site, state = site_of(k), state_of(k)
        row = [vals[isa][k] for isa in ISAS]
        ref = exact.get(k, port[k])
        if state == 3:
            models = _models(k)
            print(json.dumps({"site": site, "value": k, "state": 3,
                              "port_is_first_model": bool(np.array_equal(
                                  port[k], next(iter(models.values())))),
                              "model_of_each_compile": {
                                  i: [n for n, m in models.items()
                                      if np.array_equal(r, m)]
                                  for i, r in zip(ISAS, row)}}))
            continue
        for isa, r in zip(ISAS, row):
            if ulps(r, ref):
                spreads.setdefault(isa, {})[k] = ulps(r, ref)
        print(json.dumps({
            "site": site, "value": k, "state": state,
            "isa_independent": all(np.array_equal(row[0], r)
                                   for r in row[1:]),
            "ulps_between_isas": max(ulps(row[0], r) for r in row[1:]),
            "ulps_jax_vs_port": {i: ulps(r, port[k])
                                 for i, r in zip(ISAS, row)},
            "port_is_reference": bool(np.array_equal(port[k], ref)),
            "first": {i: float(np.ravel(r)[0])
                      for i, r in zip(ISAS, row)},
            "port_first": float(np.ravel(port[k])[0])}))
    print("SPREAD_ULPS = " + json.dumps(spreads, indent=4))


# The measured spread: the largest distance, in float32 ulps, of the JAX
# value under any of the three compiles from the exact value rounded
# once, per value (python tests/test_torch_float32_sites.py --table);
# values not listed are equal under every compile
SPREAD_ULPS = {
    "default": {
        "la/1080p_10bit_cut/variance": 4,
        "la/1080p_8bit_cut/variance": 33,
        "la/batch10_10bit_544x960/variance": 8,
        "la/rc_10_5_128x256/variance": 2,
        "la/rc_8_2_32x48/variance": 3,
        "la/rc_8_6_64x128/variance": 4,
        "la/rc_cbr_hier2_filler_x8/variance": 28,
        "la/rc_complexities/variance": 6,
        "la/rc_vbr_la8_x10/variance": 28,
        "la/uhd_2160p_10bit_cut/variance": 2,
        "la/uhd_2160p_8bit_cut/variance": 15,
        "la/uhd_4320p_8bit_cut/variance": 3,
        "la/wide_10bit_cut_1088x4224/variance": 1,
        "la/wide_10bit_cut_4224x1088/variance": 1,
        "la/wide_10bit_cut_480x720/variance": 1,
        "la/wide_10bit_cut_64x8192/variance": 1,
        "la/wide_10bit_pan_1088x4224/variance": 2,
        "la/wide_10bit_pan_4224x1088/variance": 2,
        "la/wide_10bit_pan_480x720/variance": 2,
        "la/wide_10bit_pan_64x8192/variance": 1,
        "la/wide_8bit_cut_1088x4224/variance": 1,
        "la/wide_8bit_cut_480x720/variance": 4,
        "la/wide_8bit_cut_64x8192/variance": 3,
        "la/wide_8bit_pan_1088x4224/variance": 4,
        "la/wide_8bit_pan_4224x1088/variance": 1,
        "la/wide_8bit_pan_480x720/variance": 1,
        "bv16/af_frontend_0": 5,
        "bv16/af_frontend_1": 5,
        "bv16/af_frontend_2": 5,
        "bv16/af_frontend_3": 5,
        "bv16/af_helpers_8bit_128x192_s4": 8,
        "bv16/af_uhd_nat_10bit_2176x3840": 10,
        "bv16/af_uhd_nat_8bit_2176x3840": 10,
        "bv16/helpers_10bit_64x128_s16": 7,
        "bv16/helpers_10bit_64x128_s32": 7,
        "bv16/helpers_10bit_64x128_s8": 5,
        "bv16/helpers_8bit_128x192_s32": 8,
        "bv16/helpers_8bit_128x192_s64": 7,
        "bv16/helpers_8bit_64x128_s16": 7,
        "bv16/helpers_8bit_64x128_s32": 7,
        "bv16/helpers_8bit_64x128_s8": 5,
        "bv16/nat_10bit_1088x1920": 9,
        "bv16/nat_8bit_1088x1920": 10,
        "bv32/af_frontend_0": 3,
        "bv32/af_frontend_1": 10,
        "bv32/af_frontend_2": 5,
        "bv32/af_frontend_3": 5,
        "bv32/af_helpers_8bit_128x192_s4": 26,
        "bv32/af_uhd_nat_10bit_2176x3840": 34,
        "bv32/af_uhd_nat_8bit_2176x3840": 36,
        "bv32/helpers_10bit_64x128_s16": 17,
        "bv32/helpers_10bit_64x128_s32": 13,
        "bv32/helpers_10bit_64x128_s8": 16,
        "bv32/helpers_8bit_128x192_s32": 22,
        "bv32/helpers_8bit_128x192_s64": 28,
        "bv32/helpers_8bit_64x128_s16": 17,
        "bv32/helpers_8bit_64x128_s32": 13,
        "bv32/helpers_8bit_64x128_s8": 16,
        "bv32/nat_10bit_1088x1920": 30,
        "bv32/nat_8bit_1088x1920": 34,
        "bv8/af_frontend_0": 2,
        "bv8/af_frontend_1": 2,
        "bv8/af_frontend_2": 2,
        "bv8/af_frontend_3": 2,
        "bv8/af_helpers_8bit_128x192_s4": 2,
        "bv8/af_uhd_nat_10bit_2176x3840": 3,
        "bv8/af_uhd_nat_8bit_2176x3840": 2,
        "bv8/helpers_10bit_64x128_s16": 2,
        "bv8/helpers_10bit_64x128_s32": 1,
        "bv8/helpers_10bit_64x128_s8": 2,
        "bv8/helpers_8bit_128x192_s32": 2,
        "bv8/helpers_8bit_128x192_s64": 2,
        "bv8/helpers_8bit_64x128_s16": 2,
        "bv8/helpers_8bit_64x128_s32": 1,
        "bv8/helpers_8bit_64x128_s8": 2,
        "bv8/nat_10bit_1088x1920": 3,
        "bv8/nat_8bit_1088x1920": 2,
        "ctb32/af_frontend_0": 1,
        "ctb32/af_frontend_1": 2,
        "ctb32/af_frontend_2": 2,
        "ctb32/af_frontend_3": 1,
        "ctb32/af_uhd_nat_10bit_2176x3840": 4,
        "ctb32/af_uhd_nat_8bit_2176x3840": 2,
        "ctb32/helpers_10bit_64x128_s16": 1,
        "ctb32/helpers_10bit_64x128_s32": 2,
        "ctb32/helpers_8bit_64x128_s16": 1,
        "ctb32/helpers_8bit_64x128_s32": 2,
        "ctb32/nat_10bit_1088x1920": 3,
        "ctb32/nat_8bit_1088x1920": 2,
        "ctb64/af_frontend_0": 1,
        "ctb64/af_frontend_1": 2,
        "ctb64/af_frontend_2": 3,
        "ctb64/af_frontend_3": 3,
        "ctb64/af_helpers_8bit_128x192_s4": 7,
        "ctb64/af_uhd_nat_10bit_2176x3840": 7,
        "ctb64/af_uhd_nat_8bit_2176x3840": 8,
        "ctb64/helpers_10bit_64x128_s16": 4,
        "ctb64/helpers_10bit_64x128_s32": 6,
        "ctb64/helpers_10bit_64x128_s8": 4,
        "ctb64/helpers_8bit_128x192_s32": 6,
        "ctb64/helpers_8bit_128x192_s64": 8,
        "ctb64/helpers_8bit_64x128_s16": 4,
        "ctb64/helpers_8bit_64x128_s32": 6,
        "ctb64/helpers_8bit_64x128_s8": 4,
        "ctb64/nat_10bit_1088x1920": 7,
        "ctb64/nat_8bit_1088x1920": 8,
        "af_var16/af_frontend_0": 5,
        "af_var16/af_frontend_1": 5,
        "af_var16/af_frontend_2": 5,
        "af_var16/af_frontend_3": 5,
        "af_var16/af_helpers_8bit_128x192_s4": 8,
        "af_var16/af_uhd_nat_10bit_2176x3840": 10,
        "af_var16/af_uhd_nat_8bit_2176x3840": 10,
        "af_var32/af_frontend_0": 3,
        "af_var32/af_frontend_1": 10,
        "af_var32/af_frontend_2": 5,
        "af_var32/af_frontend_3": 5,
        "af_var32/af_helpers_8bit_128x192_s4": 26,
        "af_var32/af_uhd_nat_10bit_2176x3840": 34,
        "af_var32/af_uhd_nat_8bit_2176x3840": 36,
        "af_var8/af_frontend_0": 2,
        "af_var8/af_frontend_1": 2,
        "af_var8/af_frontend_2": 2,
        "af_var8/af_frontend_3": 2,
        "af_var8/af_helpers_8bit_128x192_s4": 2,
        "af_var8/af_uhd_nat_10bit_2176x3840": 3,
        "af_var8/af_uhd_nat_8bit_2176x3840": 2,
        "sigma/nat_10bit_sd0.0_1080p_cb": 2,
        "sigma/nat_10bit_sd0.0_1080p_y": 2,
        "sigma/nat_10bit_sd1.5_1080p_cb": 2,
        "sigma/nat_10bit_sd1.5_1080p_y": 2,
        "sigma/nat_10bit_sd4.0_1080p_cb": 2,
        "sigma/nat_10bit_sd4.0_1080p_y": 1,
        "sigma/nat_10bit_sd8.0_1080p_cb": 2,
        "sigma/nat_10bit_sd8.0_1080p_y": 3,
        "sigma/nat_8bit_sd0.0_1080p_cb": 1,
        "sigma/nat_8bit_sd0.0_1080p_y": 1,
        "sigma/nat_8bit_sd1.5_1080p_cb": 1,
        "sigma/nat_8bit_sd4.0_1080p_cb": 1,
        "sigma/nat_8bit_sd4.0_1080p_y": 2,
        "sigma/nat_8bit_sd8.0_1080p_cb": 1,
        "sigma/nat_8bit_sd8.0_1080p_y": 1,
        "sigma/uhd_nat_sd1.5_10bit_2160p": 3,
        "sigma/uhd_nat_sd1.5_8bit_2160p": 1,
        "sigma/uhd_nat_sd4.0_10bit_2160p": 1,
        "sigma/uhd_nat_sd4.0_8bit_2160p": 2,
        "sse32/e255": 78,
        "sse64/e255": 64,
    },
    "avx2": {
        "la/1080p_10bit_cut/variance": 4,
        "la/1080p_8bit_cut/variance": 33,
        "la/batch10_10bit_544x960/variance": 3,
        "la/rc_10_5_128x256/variance": 1,
        "la/rc_8_2_32x48/variance": 3,
        "la/rc_8_6_64x128/variance": 1,
        "la/rc_cbr_hier2_filler_x8/variance": 5,
        "la/rc_complexities/variance": 6,
        "la/rc_vbr_la8_x10/variance": 5,
        "la/uhd_2160p_10bit_cut/variance": 2,
        "la/uhd_2160p_8bit_cut/variance": 15,
        "la/uhd_4320p_8bit_cut/variance": 3,
        "la/wide_10bit_cut_480x720/variance": 1,
        "la/wide_10bit_cut_64x8192/variance": 1,
        "la/wide_10bit_pan_1088x4224/variance": 2,
        "la/wide_10bit_pan_4224x1088/variance": 2,
        "la/wide_10bit_pan_480x720/variance": 2,
        "la/wide_10bit_pan_64x8192/variance": 1,
        "la/wide_8bit_cut_1088x4224/variance": 2,
        "la/wide_8bit_cut_480x720/variance": 4,
        "la/wide_8bit_cut_64x8192/variance": 1,
        "la/wide_8bit_pan_1088x4224/variance": 2,
        "la/wide_8bit_pan_4224x1088/variance": 1,
        "la/wide_8bit_pan_480x720/variance": 1,
        "la/wide_8bit_pan_64x8192/variance": 1,
        "bv16/af_frontend_0": 5,
        "bv16/af_frontend_1": 5,
        "bv16/af_frontend_2": 5,
        "bv16/af_frontend_3": 5,
        "bv16/af_helpers_8bit_128x192_s4": 8,
        "bv16/af_uhd_nat_10bit_2176x3840": 10,
        "bv16/af_uhd_nat_8bit_2176x3840": 10,
        "bv16/helpers_10bit_64x128_s16": 7,
        "bv16/helpers_10bit_64x128_s32": 7,
        "bv16/helpers_10bit_64x128_s8": 5,
        "bv16/helpers_8bit_128x192_s32": 8,
        "bv16/helpers_8bit_128x192_s64": 7,
        "bv16/helpers_8bit_64x128_s16": 7,
        "bv16/helpers_8bit_64x128_s32": 7,
        "bv16/helpers_8bit_64x128_s8": 5,
        "bv16/nat_10bit_1088x1920": 9,
        "bv16/nat_8bit_1088x1920": 10,
        "bv32/af_frontend_0": 3,
        "bv32/af_frontend_1": 10,
        "bv32/af_frontend_2": 5,
        "bv32/af_frontend_3": 5,
        "bv32/af_helpers_8bit_128x192_s4": 26,
        "bv32/af_uhd_nat_10bit_2176x3840": 34,
        "bv32/af_uhd_nat_8bit_2176x3840": 36,
        "bv32/helpers_10bit_64x128_s16": 17,
        "bv32/helpers_10bit_64x128_s32": 13,
        "bv32/helpers_10bit_64x128_s8": 16,
        "bv32/helpers_8bit_128x192_s32": 22,
        "bv32/helpers_8bit_128x192_s64": 28,
        "bv32/helpers_8bit_64x128_s16": 17,
        "bv32/helpers_8bit_64x128_s32": 13,
        "bv32/helpers_8bit_64x128_s8": 16,
        "bv32/nat_10bit_1088x1920": 30,
        "bv32/nat_8bit_1088x1920": 34,
        "bv8/af_frontend_0": 2,
        "bv8/af_frontend_1": 2,
        "bv8/af_frontend_2": 2,
        "bv8/af_frontend_3": 2,
        "bv8/af_helpers_8bit_128x192_s4": 2,
        "bv8/af_uhd_nat_10bit_2176x3840": 3,
        "bv8/af_uhd_nat_8bit_2176x3840": 2,
        "bv8/helpers_10bit_64x128_s16": 2,
        "bv8/helpers_10bit_64x128_s32": 1,
        "bv8/helpers_10bit_64x128_s8": 2,
        "bv8/helpers_8bit_128x192_s32": 2,
        "bv8/helpers_8bit_128x192_s64": 2,
        "bv8/helpers_8bit_64x128_s16": 2,
        "bv8/helpers_8bit_64x128_s32": 1,
        "bv8/helpers_8bit_64x128_s8": 2,
        "bv8/nat_10bit_1088x1920": 3,
        "bv8/nat_8bit_1088x1920": 2,
        "ctb32/af_frontend_0": 1,
        "ctb32/af_frontend_1": 2,
        "ctb32/af_frontend_2": 2,
        "ctb32/af_frontend_3": 1,
        "ctb32/af_uhd_nat_10bit_2176x3840": 4,
        "ctb32/af_uhd_nat_8bit_2176x3840": 2,
        "ctb32/helpers_10bit_64x128_s16": 1,
        "ctb32/helpers_10bit_64x128_s32": 2,
        "ctb32/helpers_8bit_64x128_s16": 1,
        "ctb32/helpers_8bit_64x128_s32": 2,
        "ctb32/nat_10bit_1088x1920": 3,
        "ctb32/nat_8bit_1088x1920": 2,
        "ctb64/af_frontend_0": 1,
        "ctb64/af_frontend_1": 2,
        "ctb64/af_frontend_2": 3,
        "ctb64/af_frontend_3": 3,
        "ctb64/af_helpers_8bit_128x192_s4": 7,
        "ctb64/af_uhd_nat_10bit_2176x3840": 7,
        "ctb64/af_uhd_nat_8bit_2176x3840": 8,
        "ctb64/helpers_10bit_64x128_s16": 4,
        "ctb64/helpers_10bit_64x128_s32": 6,
        "ctb64/helpers_10bit_64x128_s8": 4,
        "ctb64/helpers_8bit_128x192_s32": 6,
        "ctb64/helpers_8bit_128x192_s64": 8,
        "ctb64/helpers_8bit_64x128_s16": 4,
        "ctb64/helpers_8bit_64x128_s32": 6,
        "ctb64/helpers_8bit_64x128_s8": 4,
        "ctb64/nat_10bit_1088x1920": 7,
        "ctb64/nat_8bit_1088x1920": 8,
        "af_var16/af_frontend_0": 5,
        "af_var16/af_frontend_1": 5,
        "af_var16/af_frontend_2": 5,
        "af_var16/af_frontend_3": 5,
        "af_var16/af_helpers_8bit_128x192_s4": 8,
        "af_var16/af_uhd_nat_10bit_2176x3840": 10,
        "af_var16/af_uhd_nat_8bit_2176x3840": 10,
        "af_var32/af_frontend_0": 3,
        "af_var32/af_frontend_1": 10,
        "af_var32/af_frontend_2": 5,
        "af_var32/af_frontend_3": 5,
        "af_var32/af_helpers_8bit_128x192_s4": 26,
        "af_var32/af_uhd_nat_10bit_2176x3840": 34,
        "af_var32/af_uhd_nat_8bit_2176x3840": 36,
        "af_var8/af_frontend_0": 2,
        "af_var8/af_frontend_1": 2,
        "af_var8/af_frontend_2": 2,
        "af_var8/af_frontend_3": 2,
        "af_var8/af_helpers_8bit_128x192_s4": 2,
        "af_var8/af_uhd_nat_10bit_2176x3840": 3,
        "af_var8/af_uhd_nat_8bit_2176x3840": 2,
        "sigma/nat_10bit_sd0.0_1080p_y": 2,
        "sigma/nat_10bit_sd1.5_1080p_y": 2,
        "sigma/nat_10bit_sd4.0_1080p_y": 1,
        "sigma/nat_10bit_sd8.0_1080p_y": 3,
        "sigma/nat_8bit_sd0.0_1080p_cb": 3,
        "sigma/nat_8bit_sd0.0_1080p_y": 1,
        "sigma/nat_8bit_sd1.5_1080p_cb": 3,
        "sigma/nat_8bit_sd4.0_1080p_cb": 3,
        "sigma/nat_8bit_sd4.0_1080p_y": 2,
        "sigma/nat_8bit_sd8.0_1080p_cb": 3,
        "sigma/nat_8bit_sd8.0_1080p_y": 1,
        "sigma/uhd_nat_sd1.5_10bit_2160p": 3,
        "sigma/uhd_nat_sd1.5_8bit_2160p": 1,
        "sigma/uhd_nat_sd4.0_10bit_2160p": 1,
        "sigma/uhd_nat_sd4.0_8bit_2160p": 2,
        "sse64/e255": 1,
    },
    "sse4_2": {
        "la/1080p_10bit_cut/variance": 4,
        "la/1080p_8bit_cut/variance": 33,
        "la/batch10_10bit_544x960/variance": 3,
        "la/rc_10_5_128x256/variance": 1,
        "la/rc_8_2_32x48/variance": 3,
        "la/rc_8_6_64x128/variance": 1,
        "la/rc_cbr_hier2_filler_x8/variance": 4,
        "la/rc_complexities/variance": 6,
        "la/rc_vbr_la8_x10/variance": 4,
        "la/uhd_2160p_10bit_cut/variance": 2,
        "la/uhd_2160p_8bit_cut/variance": 15,
        "la/uhd_4320p_10bit_cut/variance": 1,
        "la/uhd_4320p_8bit_cut/variance": 3,
        "la/wide_10bit_cut_1088x4224/variance": 1,
        "la/wide_10bit_cut_4224x1088/variance": 1,
        "la/wide_10bit_cut_480x720/variance": 1,
        "la/wide_10bit_cut_64x8192/variance": 1,
        "la/wide_10bit_pan_1088x4224/variance": 2,
        "la/wide_10bit_pan_4224x1088/variance": 1,
        "la/wide_10bit_pan_480x720/variance": 2,
        "la/wide_10bit_pan_64x8192/variance": 1,
        "la/wide_8bit_cut_1088x4224/variance": 2,
        "la/wide_8bit_cut_480x720/variance": 4,
        "la/wide_8bit_cut_64x8192/variance": 1,
        "la/wide_8bit_pan_1088x4224/variance": 2,
        "la/wide_8bit_pan_480x720/variance": 1,
        "la/wide_8bit_pan_64x8192/variance": 2,
        "bv16/af_frontend_0": 8,
        "bv16/af_frontend_1": 8,
        "bv16/af_frontend_2": 8,
        "bv16/af_frontend_3": 8,
        "bv16/af_helpers_8bit_128x192_s4": 14,
        "bv16/af_uhd_nat_10bit_2176x3840": 20,
        "bv16/af_uhd_nat_8bit_2176x3840": 19,
        "bv16/helpers_10bit_64x128_s16": 12,
        "bv16/helpers_10bit_64x128_s32": 14,
        "bv16/helpers_10bit_64x128_s8": 10,
        "bv16/helpers_8bit_128x192_s32": 15,
        "bv16/helpers_8bit_128x192_s64": 12,
        "bv16/helpers_8bit_64x128_s16": 12,
        "bv16/helpers_8bit_64x128_s32": 14,
        "bv16/helpers_8bit_64x128_s8": 10,
        "bv16/nat_10bit_1088x1920": 17,
        "bv16/nat_8bit_1088x1920": 19,
        "bv32/af_frontend_0": 12,
        "bv32/af_frontend_1": 5,
        "bv32/af_frontend_2": 6,
        "bv32/af_frontend_3": 15,
        "bv32/af_helpers_8bit_128x192_s4": 40,
        "bv32/af_uhd_nat_10bit_2176x3840": 57,
        "bv32/af_uhd_nat_8bit_2176x3840": 67,
        "bv32/helpers_10bit_64x128_s16": 14,
        "bv32/helpers_10bit_64x128_s32": 53,
        "bv32/helpers_10bit_64x128_s8": 32,
        "bv32/helpers_8bit_128x192_s32": 45,
        "bv32/helpers_8bit_128x192_s64": 42,
        "bv32/helpers_8bit_64x128_s16": 14,
        "bv32/helpers_8bit_64x128_s32": 53,
        "bv32/helpers_8bit_64x128_s8": 32,
        "bv32/nat_10bit_1088x1920": 56,
        "bv32/nat_8bit_1088x1920": 66,
        "bv8/af_frontend_0": 4,
        "bv8/af_frontend_1": 3,
        "bv8/af_frontend_2": 4,
        "bv8/af_frontend_3": 3,
        "bv8/af_helpers_8bit_128x192_s4": 6,
        "bv8/af_uhd_nat_10bit_2176x3840": 6,
        "bv8/af_uhd_nat_8bit_2176x3840": 6,
        "bv8/helpers_10bit_64x128_s16": 4,
        "bv8/helpers_10bit_64x128_s32": 4,
        "bv8/helpers_10bit_64x128_s8": 4,
        "bv8/helpers_8bit_128x192_s32": 4,
        "bv8/helpers_8bit_128x192_s64": 4,
        "bv8/helpers_8bit_64x128_s16": 4,
        "bv8/helpers_8bit_64x128_s32": 4,
        "bv8/helpers_8bit_64x128_s8": 4,
        "bv8/nat_10bit_1088x1920": 5,
        "bv8/nat_8bit_1088x1920": 6,
        "ctb32/af_frontend_0": 2,
        "ctb32/af_frontend_1": 2,
        "ctb32/af_frontend_2": 1,
        "ctb32/af_frontend_3": 2,
        "ctb32/af_helpers_8bit_128x192_s4": 2,
        "ctb32/af_uhd_nat_10bit_2176x3840": 5,
        "ctb32/af_uhd_nat_8bit_2176x3840": 2,
        "ctb32/helpers_10bit_64x128_s16": 1,
        "ctb32/helpers_10bit_64x128_s32": 1,
        "ctb32/helpers_10bit_64x128_s8": 1,
        "ctb32/helpers_8bit_128x192_s32": 1,
        "ctb32/helpers_8bit_128x192_s64": 1,
        "ctb32/helpers_8bit_64x128_s16": 1,
        "ctb32/helpers_8bit_64x128_s32": 1,
        "ctb32/helpers_8bit_64x128_s8": 1,
        "ctb32/nat_10bit_1088x1920": 4,
        "ctb32/nat_8bit_1088x1920": 2,
        "ctb64/af_frontend_0": 2,
        "ctb64/af_frontend_1": 2,
        "ctb64/af_frontend_2": 3,
        "ctb64/af_frontend_3": 3,
        "ctb64/af_helpers_8bit_128x192_s4": 5,
        "ctb64/af_uhd_nat_10bit_2176x3840": 7,
        "ctb64/af_uhd_nat_8bit_2176x3840": 7,
        "ctb64/helpers_10bit_64x128_s16": 3,
        "ctb64/helpers_10bit_64x128_s32": 4,
        "ctb64/helpers_10bit_64x128_s8": 3,
        "ctb64/helpers_8bit_128x192_s32": 4,
        "ctb64/helpers_8bit_128x192_s64": 7,
        "ctb64/helpers_8bit_64x128_s16": 3,
        "ctb64/helpers_8bit_64x128_s32": 4,
        "ctb64/helpers_8bit_64x128_s8": 3,
        "ctb64/nat_10bit_1088x1920": 7,
        "ctb64/nat_8bit_1088x1920": 6,
        "af_var16/af_frontend_0": 8,
        "af_var16/af_frontend_1": 8,
        "af_var16/af_frontend_2": 8,
        "af_var16/af_frontend_3": 8,
        "af_var16/af_helpers_8bit_128x192_s4": 14,
        "af_var16/af_uhd_nat_10bit_2176x3840": 20,
        "af_var16/af_uhd_nat_8bit_2176x3840": 19,
        "af_var32/af_frontend_0": 12,
        "af_var32/af_frontend_1": 5,
        "af_var32/af_frontend_2": 6,
        "af_var32/af_frontend_3": 15,
        "af_var32/af_helpers_8bit_128x192_s4": 40,
        "af_var32/af_uhd_nat_10bit_2176x3840": 57,
        "af_var32/af_uhd_nat_8bit_2176x3840": 67,
        "af_var8/af_frontend_0": 4,
        "af_var8/af_frontend_1": 3,
        "af_var8/af_frontend_2": 4,
        "af_var8/af_frontend_3": 3,
        "af_var8/af_helpers_8bit_128x192_s4": 6,
        "af_var8/af_uhd_nat_10bit_2176x3840": 6,
        "af_var8/af_uhd_nat_8bit_2176x3840": 6,
        "sigma/nat_10bit_sd0.0_1080p_y": 2,
        "sigma/nat_10bit_sd1.5_1080p_y": 2,
        "sigma/nat_10bit_sd4.0_1080p_y": 1,
        "sigma/nat_10bit_sd8.0_1080p_y": 3,
        "sigma/nat_8bit_sd0.0_1080p_cb": 3,
        "sigma/nat_8bit_sd0.0_1080p_y": 1,
        "sigma/nat_8bit_sd1.5_1080p_cb": 3,
        "sigma/nat_8bit_sd4.0_1080p_cb": 3,
        "sigma/nat_8bit_sd4.0_1080p_y": 2,
        "sigma/nat_8bit_sd8.0_1080p_cb": 3,
        "sigma/nat_8bit_sd8.0_1080p_y": 1,
        "sigma/uhd_nat_sd1.5_10bit_2160p": 3,
        "sigma/uhd_nat_sd1.5_8bit_2160p": 1,
        "sigma/uhd_nat_sd4.0_10bit_2160p": 1,
        "sigma/uhd_nat_sd4.0_8bit_2160p": 2,
        "sse64/e255": 1,
    },
}


def jax_within_spread(value, exact, isa: str, key: str) -> bool:
    """Whether a JAX value under compile isa lies within the spread
    measured for it from the exact value rounded once."""
    return ulps(value, exact) <= SPREAD_ULPS.get(isa, {}).get(key, 0)


# the inputs of each other test file that holds a host-dependent site
# (one JAX subprocess per compile and file)
GROUPS = {
    "rc": ("rc_8_6_64x128", "rc_10_5_128x256", "rc_8_2_32x48",
           "rc_complexities", "rc_vbr_la8_x10", "rc_cbr_hier2_filler_x8"),
    "helpers": tuple(f"helpers_{bd}bit_64x128_s{n}" for bd in (8, 10)
                     for n in (8, 16, 32))
    + ("helpers_8bit_128x192_s32", "helpers_8bit_128x192_s64",
       "af_helpers_8bit_128x192_s4"),
    "frontend": tuple(f"af_frontend_{i}" for i in range(4)),
    "fullsize": tuple(f"ramp_{bd}bit_1088x1920" for bd in (8, 10))
    + tuple(f"nat_{bd}bit_sd{sd}_1080p_{c}" for bd in (8, 10)
            for sd in (0.0, 1.5, 4.0, 8.0) for c in ("y", "cb")),
}


def assert_host_dependent(key: str, group: str, port, exact) -> None:
    """A host-dependent site's value in another test: the port's equals
    the exact value rounded once, bit for bit, and the JAX graph's under
    each of the three compiles (computed for GROUPS[group]) lies within
    its measured spread."""
    np.testing.assert_array_equal(port, exact, err_msg=key)
    for isa in ISAS:
        got = jax_values(isa, GROUPS[group])[key]
        assert jax_within_spread(got, exact, isa, key), (isa, key)


@pytest.fixture(scope="module")
def port_values():
    return port_site_values()


@pytest.fixture(scope="module")
def exact_values():
    return exact_site_values()


@pytest.mark.parametrize("isa", list(ISAS))
@pytest.mark.parametrize("site", list(SITES))
def test_site_under_each_compile(site, isa, port_values, exact_values):
    """State 1: the port equals the JAX value under this compile. State
    2: the port equals the float64 reference rounded once, bit for bit,
    and the JAX value under this compile lies within the spread."""
    jv = jax_values(isa)
    keys = site_keys(site, jv)
    assert keys
    for k in keys:
        assert port_values[k].dtype == np.float32, k
        if SITES[site][1] == 1:
            np.testing.assert_array_equal(port_values[k], jv[k], err_msg=k)
        elif SITES[site][1] == 3:
            models = _models(k)
            np.testing.assert_array_equal(port_values[k],
                                          next(iter(models.values())))
            assert any(np.array_equal(jv[k], m) for m in models.values()), k
        else:
            np.testing.assert_array_equal(port_values[k], exact_values[k],
                                          err_msg=k)
            assert jax_within_spread(jv[k], exact_values[k], isa, k), k


@pytest.mark.parametrize("site", list(SITES))
def test_site_state_holds_across_the_compiles(site):
    """A state-1 site gives the same bits under the three compiles on every
    input; a state-2 site differs between two of them on some input."""
    vals = [jax_values(isa) for isa in ISAS]
    same = [all(np.array_equal(vals[0][k], v[k]) for v in vals[1:])
            for k in site_keys(site, vals[0])]
    assert all(same) == (SITES[site][1] == 1)


def test_capped_compiles_round_as_measured():
    """XLA compiled for AVX2 or SSE4_2 sums a float32 2x2 window pairwise,
    and for SSE4_2 rounds a product and its add apart: the arithmetic
    the port follows (an AVX-512 host's) is not every host's."""
    models = {k: _models(k) for k in ("fma/xla", "box2/xla")}
    for isa in ("avx2", "sse4_2"):
        np.testing.assert_array_equal(jax_values(isa)["box2/xla"],
                                      models["box2/xla"]["pairwise"])
    np.testing.assert_array_equal(jax_values("sse4_2")["fma/xla"],
                                  models["fma/xla"]["two roundings"])
    np.testing.assert_array_equal(jax_values("avx2")["fma/xla"],
                                  models["fma/xla"]["fused"])


def test_ordered_sum_is_the_left_to_right_float32_chain():
    """K3's plain version adds each row left to right in float32, which
    separates it from a pairwise or a float64 sum on these rows."""
    from svt_hevc_tpu_torch.gpu import kernels as K
    rng = np.random.default_rng(3)
    parts = (rng.integers(0, 1 << 20, (289, 135)) / 16.0).astype(np.float32)
    parts[:, 0] = 2.0 ** 24
    want = np.add.accumulate(parts, axis=1, dtype=np.float32)[:, -1]
    chain = K.SumPlan(135, 1, 135, 1)
    got = K.ordered_sum(torch.from_numpy(parts), chain).numpy()
    np.testing.assert_array_equal(got, want)
    assert not np.array_equal(got, parts.astype(np.float64).sum(1).astype(
        np.float32))
    assert K.ordered_sum(torch.zeros(4, 0), K.SumPlan(0, 1, 1, 1)).tolist() \
        == [0.0] * 4
    with pytest.raises(ValueError):
        K.ordered_sum(torch.zeros(4, 3, dtype=torch.float64),
                      K.SumPlan(3, 1, 3, 1))
    with pytest.raises(ValueError):
        K.ordered_sum(torch.zeros(4, 3), K.SumPlan(3, 1, 3, 1, lanes=3))


def np_plan_sum(x: np.ndarray, q) -> np.ndarray:
    """The float32 sum of each (gh, gw) grid of x (N, gh, gw) in the order
    XLA:CPU reduces it (a SumPlan, as measured: ROADMAP §3), spelled out
    in numpy: per window, its rows dealt round-robin to the lanes, each
    lane a left-to-right chain, the lanes halved, the remaining rows and
    then, with split, the last column chained on; the windows of an
    output row chained, then the output rows."""
    f32 = np.float32
    zero = np.zeros(x.shape[0], f32)

    def chain(acc, cells):
        for r, c in cells:
            if 0 <= r < q.gh and 0 <= c < q.gw:
                acc = (acc + x[:, r, c]).astype(f32)
        return acc

    total = zero
    for a in range(q.oh):
        row = zero
        for b in range(q.ow):
            rows = [a * q.wh + i - q.ph for i in range(q.wh)]
            cols = [b * q.ww + j - q.pw for j in range(q.ww)]
            body = cols[:len(cols) - q.split]
            main = q.wh - q.wh % q.lanes
            lanes = [chain(zero, [(r, c) for r in rows[lane:main:q.lanes]
                                  for c in body])
                     for lane in range(q.lanes)]
            while len(lanes) > 1:
                h = len(lanes) // 2
                lanes = [(lanes[i] + lanes[i + h]).astype(f32)
                         for i in range(h)]
            w = chain(lanes[0], [(r, c) for r in rows[main:] for c in body])
            if q.split:
                w = chain(w, [(r, cols[-1]) for r in rows])
            row = (row + w).astype(f32)
        total = (total + row).astype(f32)
    return total


# (grid, the reference compile's plan): the 4320p lookahead's two levels
# of 2 x 2 windows, 1088x4224's 1 x 2 windows, 4224x1088's 2 x 1, an 8064
# wide luma's split last column, and single-step grids over 2, 4 and 8
# lanes with and without remaining rows
PLANS = {
    (34, 60): (34, 60, 32, 32, 15, 2, 2, 2, 1, 0),
    (9, 33): (9, 33, 9, 32, 0, 15, 1, 2, 1, 0),
    (33, 9): (33, 9, 32, 9, 15, 0, 2, 1, 1, 0),
    (17, 63): (17, 63, 17, 32, 0, 0, 1, 2, 1, 1),
    (9, 15): (9, 15, 9, 15, 0, 0, 1, 1, 1, 0),
    (2, 5): (2, 5, 2, 5, 0, 0, 1, 1, 2, 0),
    (4, 6): (4, 6, 4, 6, 0, 0, 1, 1, 4, 0),
    (17, 2): (17, 2, 17, 2, 0, 0, 1, 1, 8, 0),
    (21, 4): (21, 4, 21, 4, 0, 0, 1, 1, 4, 0),
    (31, 7): (31, 7, 31, 7, 0, 0, 1, 1, 4, 0),
}


@pytest.mark.parametrize("grid", list(PLANS), ids=lambda g: f"{g[0]}x{g[1]}")
def test_ordered_sum_follows_xla_reduce_plan(grid):
    """The reference compile's plan of each grid (ROADMAP §3), and K3's
    plain version under it equal to the order spelled out in numpy, on
    sums whose running totals pass 2^24, where every plan but 1080p's
    one-window row-by-row chain differs from the left-to-right chain."""
    from svt_hevc_tpu_torch.gpu import analysis as ta
    from svt_hevc_tpu_torch.gpu import kernels as K
    q = ta.xla_reduce_plan(*grid)
    assert tuple(q) == PLANS[grid]
    rng = np.random.default_rng(grid[0] * 100 + grid[1])
    x = (rng.integers(1, 1 << 22, (64, *grid))
         * rng.choice([1, 2, 4, 8, 16], (64, *grid))).astype(np.float32)
    got = K.ordered_sum(torch.from_numpy(x.reshape(64, -1)), q).numpy()
    np.testing.assert_array_equal(got, np_plan_sum(x, q))
    chain = np.add.accumulate(x.reshape(64, -1), axis=1,
                              dtype=np.float32)[:, -1]
    is_chain = q.lanes == 1 and q.oh * q.ow == 1 and not q.split
    assert np.array_equal(got, chain) == is_chain
    with pytest.raises(ValueError):
        K.ordered_sum(torch.from_numpy(x.reshape(64, -1)[:, 1:]), q)


def test_xla_reduce_plan_covers_every_frame_size():
    """A plan for every grid of the lookahead's SAD windows up to the
    largest frame the encoder accepts (8192x4320: 34 x 64), none past it."""
    from svt_hevc_tpu_torch.gpu import analysis as ta
    for gh in range(1, 35):
        for gw in range(1, 65):
            q = ta.xla_reduce_plan(gh, gw)
            assert q.oh * q.wh >= gh and q.ow * q.ww >= gw
    for grid in ((35, 64), (34, 65)):
        with pytest.raises(ValueError):
            ta.xla_reduce_plan(*grid)


# ------------------------------------------ XLA's reduce order, all grids

# the lookahead grids of window sums (decimated plane / 32, rounded up)
# at the frame sizes the tests and chip_smoke.py encode: each compile's
# order is the reference compile's at all but 2160p's
LA_GRIDS = {"1080p": (9, 15), "2160p": (17, 30), "4320p": (34, 60),
            "8192x4320": (34, 64), "1088x4224": (9, 33),
            "4224x1088": (33, 9), "64x8192": (1, 64), "480x720": (4, 6)}


def _xla_grid_sum(gh: int, gw: int):
    """The jitted float32 reduce XLA:CPU applies to a (B, gh, gw) grid of
    window sums inside lookahead_stats: one step for a grid of at most 32
    x 32, else the second level of reduce-windows the lookahead's HLO
    shows (32 on an axis longer than 32, zero padding to a multiple of
    32, the lower half first) and the reduce of their grid."""
    import jax
    from jax import lax
    if gh <= 32 and gw <= 32:
        return jax.jit(lambda g: g.sum(axis=(1, 2)))

    def win(n):
        if n <= 32:
            return n, (0, 0)
        p = -n % 32
        return 32, (p // 2, p - p // 2)

    (wh, ph), (ww, pw) = win(gh), win(gw)
    return jax.jit(lambda g: lax.reduce_window(
        g, 0.0, lax.add, (1, wh, ww), (1, wh, ww), ((0, 0), ph, pw)).sum(
            axis=(1, 2)))


def plan_check() -> dict:
    """Whether the port's plan (xla_reduce_plan, K3's plain version) gives
    this process's XLA compile's sums bit for bit, for every grid up to
    PLAN_MAX_GRID, on 48 random grids of float32 window sums whose
    running totals pass 2^24: {"grids": n, "differ": [[gh, gw], ...],
    "row_by_row_2x2": whether this compile is the reference's kind}."""
    from svt_hevc_tpu_torch.gpu import analysis as ta
    from svt_hevc_tpu_torch.gpu import kernels as K
    differ, n = [], 0
    for gh in range(1, ta.PLAN_MAX_GRID[0] + 1):
        for gw in range(1, ta.PLAN_MAX_GRID[1] + 1):
            rng = np.random.default_rng(gh * 1000 + gw)
            x = (rng.integers(1, 1 << 22, (48, gh * gw))
                 * rng.choice([1, 2, 4, 8, 16], (48, gh * gw))).astype(
                     np.float32)
            got = np.asarray(_xla_grid_sum(gh, gw)(x.reshape(48, gh, gw)))
            port = K.ordered_sum(torch.from_numpy(x),
                                 ta.xla_reduce_plan(gh, gw)).numpy()
            n += 1
            if not np.array_equal(got, port):
                differ.append([gh, gw])
    return {"grids": n, "differ": differ,
            "row_by_row_2x2": xla_sums_2x2_row_by_row()}


def reveal_tree(gh: int, gw: int, batch: int = 512):
    """The add tree of this compile's reduce of a gh x gw grid
    (_xla_grid_sum), as nested pairs of row-major grid indices: value i
    is set to 2^40, value j to -2^40 and every other to 1, so the sum
    counts the ones added after i and j cancel, which gives the size of
    the smallest subtree holding both (the FPRev method); the subtrees
    are then split recursively."""
    import random
    f = _xla_grid_sum(gh, gw)
    n = gh * gw
    big = np.float32(2.0 ** 40)

    def lca_sizes(i, js):
        out = []
        for k in range(0, len(js), batch):
            chunk = js[k:k + batch]
            g = np.ones((batch, n), np.float32)
            g[:, i] = big
            g[np.arange(len(chunk)), chunk] = -big
            r = np.asarray(f(g.reshape(batch, gh, gw)))[:len(chunk)]
            out.extend((n - r).astype(np.int64).tolist())
        return out

    def build(leaves, rng):
        if len(leaves) == 1:
            return leaves[0]
        i = rng.choice(leaves)
        js = [j for j in leaves if j != i]
        groups = {}
        for j, size in zip(js, lca_sizes(i, js)):
            groups.setdefault(size, []).append(j)
        tree = i
        for size in sorted(groups):
            tree = [tree, build(groups[size], rng)]
        return tree

    sys.setrecursionlimit(max(sys.getrecursionlimit(), 10 * n + 100))
    return build(list(range(n)), random.Random(0))


@pytest.mark.slow
@pytest.mark.parametrize("isa", list(ISAS))
def test_xla_reduce_plan_under_each_compile(isa):
    """The port's plan of every grid up to PLAN_MAX_GRID against a fresh
    compile: the reference compile's order everywhere (on a host whose
    default compile is the reference's kind); under the AVX2 and SSE4_2
    compiles the same at every LA_GRIDS size but 2160p's."""
    r = run_worker(os.path.abspath(__file__), isa, ("--plans",),
                   UHD_WORKER_TIMEOUT_S)
    differ = {tuple(g) for g in r["differ"].tolist()} if r[
        "differ"].size else set()
    assert int(r["grids"]) == 34 * 64
    if isa == "default" and bool(r["row_by_row_2x2"]):
        assert differ == set()
    if isa != "default":
        assert {k for k, g in LA_GRIDS.items() if g in differ} == {"2160p"}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--worker", metavar="OUT_NPZ")
    ap.add_argument("--inputs", help="comma-separated input names")
    ap.add_argument("--table", action="store_true")
    ap.add_argument("--set", choices=["regular", "uhd", "all"],
                    default="all", help="the inputs --table measures")
    ap.add_argument("--plans", action="store_true",
                    help="with --worker: plan_check() of this compile")
    ap.add_argument("--reveal", metavar="GHxGW",
                    help="print this compile's add tree of a grid")
    args = ap.parse_args(argv)
    if args.worker and args.plans:
        os.environ.setdefault("JAX_PLATFORMS", "cpu")
        r = plan_check()
        np.savez(args.worker, grids=r["grids"],
                 differ=np.array(r["differ"], np.int64).reshape(-1, 2),
                 row_by_row_2x2=r["row_by_row_2x2"])
    elif args.reveal:
        gh, gw = map(int, args.reveal.split("x"))
        print(json.dumps(reveal_tree(gh, gw)))
    elif args.worker:
        _worker(args.worker,
                set(args.inputs.split(",")) if args.inputs else None)
    elif args.table:
        _table(args.set)
    return 0


if __name__ == "__main__":
    sys.exit(main())
