"""The float32 arithmetic of the jitted JAX graphs, in the port.

XLA:CPU contracts a float32 product that feeds an add or a subtract in
the same fusion into one multiply-add (one rounding); eager PyTorch
rounds the product and the sum apart. Where the product is not an
integer the two differ in the last bit, and a cost that decides between
two near-equal candidates can then pick the other one (pictures 19-23
of BD_r05_1080p_ipp.json's clip at 192x128, qp 28, decided one 16x16 CU
otherwise). The port computes those costs with gpu.encode._fma
(float64 product and sum, rounded to float32 once). The sites are the
f32 multiply -> add pairs inside the fusions of the jitted fused-path
graphs (_fast_p_front / _fast_p_finish / _fast_b_front / _fast_b_finish /
fast_i_fused_dev): _rd_leaf_cost (and its intra form), _tu_rd_better,
_tu_tree_dp and the two SAO scores; the others there add integer-valued
products, which are exact either way. Each is held bit for bit against
the jitted JAX function here.

XLA:CPU also fixes the order of a float32 sum: a reduce over the two
axes of a 2x2 window adds row by row, ((a00 + a01) + a10) + a11, and
the split DPs (P, B and I quadtree decisions, the TU tree) sum their
children's costs that way. The port summed pairwise, and at CTB 64 and
qp 27 the 1080p clip of BD_r05_1080p_ipp.json came out 6 bytes short of
the JAX package's stream: in P picture 22 one 16x16 CU's leaf cost
equals its four 8x8 children's sum plus the split charge in one order
and not in the other. That CTB's inputs to decide_tree_dev
(tests/torch_qp27_ctb.npz) are held against the jitted JAX function.

The reference arithmetic is that of the default compile on an AVX-512
host with the compile cache off: it contracts the multiply-adds and sums
2x2 windows row by row, and it made the BD_r05_*.json artifacts and
chip_smoke.JAX_1080P. Other compiles differ: XLA capped at AVX2 sums
2x2 windows pairwise, and at SSE4_2 it also rounds a product and its add
apart (tests/test_torch_float32_sites.py). So each test below holds the
port's output, bit for bit, to RECORDS: the JAX functions' outputs under
that reference compile, as a sha256 of each output's bytes with its
dtype and shape. It holds the JAX function compiled in this process as
well: to the record where this process's compile has the reference
arithmetic (the probes xla_contracts_multiply_add and
xla_sums_2x2_row_by_row), else to the other model of the arithmetic,
the port's function with the product and its add rounded twice or the
2x2 window summed pairwise. Every input comes from its own seeded
generator. The records are remade, on an AVX-512 host, by

    python tests/test_torch_fma.py --record

which compiles the JAX functions in a subprocess (the compile cache off,
no ISA cap), refuses a compile without the reference arithmetic and
rewrites RECORDS in this file.
"""

import argparse
import contextlib
import functools
import hashlib
import os
import re
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from svt_hevc_tpu.tpu import encode as jenc  # noqa: E402
from svt_hevc_tpu.tpu import sao as jsao  # noqa: E402
from svt_hevc_tpu_torch.gpu import encode as genc  # noqa: E402
from svt_hevc_tpu_torch.gpu import sao as gsao  # noqa: E402
from tests.test_torch_encoder import one_torch_thread  # noqa: E402,F401
from tests.test_torch_float32_sites import (  # noqa: E402
    run_worker, xla_contracts_multiply_add, xla_sums_2x2_row_by_row)

QP27_CTB = os.path.join(ROOT, "tests", "torch_qp27_ctb.npz")

# Per case, (dtype, shape, sha256 of the bytes) of each output of the JAX
# function under the reference compile; written by --record
# -- records begin --
RECORDS = {
    "fma": (
        ("float32", (4096,),
         "704c9bfa257eb106611cd2fdc076f8b96c3eb4b351e0183ac800a32eed11073c"),
    ),
    "rd_leaf_cost/False-8": (
        ("float32", (16, 24),
         "72a982495c78219d32624e527030008461f15e0ae9a7dbe5281861c28518d136"),
    ),
    "rd_leaf_cost/False-16": (
        ("float32", (8, 12),
         "3a6112d3a8796fb4dd553ea08f91758b40a2dffbe6ef11ccb1f36a96b7660b1a"),
    ),
    "rd_leaf_cost/False-32": (
        ("float32", (4, 6),
         "f41fe34a87a8abe847fb3600cc43ed6865cd36ee2c9d6dc6f4a4823c7155cb3d"),
    ),
    "rd_leaf_cost/False-64": (
        ("float32", (2, 3),
         "5b6bebc13b139e62abaa94b809e1e7b168701fa0739e068b6dc3ecadf0661af6"),
    ),
    "rd_leaf_cost/True-8": (
        ("float32", (16, 24),
         "6767b447a1a6686d0971a8a1110ff8b67da56c0fde684bf4167d9aee8e1660cd"),
    ),
    "rd_leaf_cost/True-16": (
        ("float32", (8, 12),
         "63d5a2b8dc531b0699af00bc5f0b55a410cbdfc622ae0d2929966418c4a49034"),
    ),
    "rd_leaf_cost/True-32": (
        ("float32", (4, 6),
         "ed57252ad92a54d831c8f9a8645d3eddce5f30192f55f7d9f2f7157a27ec9dac"),
    ),
    "rd_leaf_cost/True-64": (
        ("float32", (2, 3),
         "a6ea1c90ac4a20859e002c4b4de5a3bd86424b9e2f67976a366c11c0a5c86430"),
    ),
    "tu_rd_better": (
        ("bool", (10, 1, 1),
         "b3b04044082ba5a13bd7638d7dfd86ad5237d5e034d6403f999b19e288da43bd"),
    ),
    "sao": (
        ("int32", (6, 9),
         "7acc7d2766b9d11734ca38040fdea0ae26ce946171d8645ea3255f591585bd01"),
        ("int32", (6, 9, 4),
         "8678bb299ebbe93ebd90184625636f4dd0a00ab08748e2909df785bf60e4039b"),
        ("float32", (6, 9),
         "0c047b777d5b36a0da518a0b936ddbcb349f4ab7749bcabff8bf8b8fc58975fb"),
        ("int32", (6, 9, 3),
         "f7827e259869aacd27de2f5cbadcd8f1a68d07b20ae1054dc274d73ff025349c"),
        ("int32", (6, 9, 2),
         "9607a9c1ffa6dc35a8ece453910bc7ed8ff78f977272ef93192000ca425c0205"),
        ("int32", (6, 9, 3, 4),
         "7db752ecffbbb476d7dfb3ab09801e5c2218083dbb38b25136ba0a065f2a487f"),
        ("int32", (6, 9, 2),
         "dd2df1065eef8abdb88ea6a47cdfd35a9ea5e525e1ff87cff8ebc03d0e2cae20"),
        ("int32", (6, 9),
         "7acc7d2766b9d11734ca38040fdea0ae26ce946171d8645ea3255f591585bd01"),
        ("int32", (6, 9, 4),
         "8678bb299ebbe93ebd90184625636f4dd0a00ab08748e2909df785bf60e4039b"),
        ("float32", (6, 9),
         "59192c273a14a2cbd3d48a5f41a66ea94d3cd3ea8f0a793043968a28100251c4"),
        ("int32", (6, 9, 3),
         "f7827e259869aacd27de2f5cbadcd8f1a68d07b20ae1054dc274d73ff025349c"),
        ("int32", (6, 9, 2),
         "9607a9c1ffa6dc35a8ece453910bc7ed8ff78f977272ef93192000ca425c0205"),
        ("int32", (6, 9, 3, 4),
         "7db752ecffbbb476d7dfb3ab09801e5c2218083dbb38b25136ba0a065f2a487f"),
        ("int32", (6, 9, 2),
         "dd2df1065eef8abdb88ea6a47cdfd35a9ea5e525e1ff87cff8ebc03d0e2cae20"),
        ("int32", (6, 9),
         "7acc7d2766b9d11734ca38040fdea0ae26ce946171d8645ea3255f591585bd01"),
        ("int32", (6, 9, 4),
         "8678bb299ebbe93ebd90184625636f4dd0a00ab08748e2909df785bf60e4039b"),
        ("float32", (6, 9),
         "4a1ffbcab07474ef193df59ee5a0e6b53653a1d2f7989f62e4127e221e811fa0"),
        ("int32", (6, 9, 3),
         "f7827e259869aacd27de2f5cbadcd8f1a68d07b20ae1054dc274d73ff025349c"),
        ("int32", (6, 9, 2),
         "9607a9c1ffa6dc35a8ece453910bc7ed8ff78f977272ef93192000ca425c0205"),
        ("int32", (6, 9, 3, 4),
         "7db752ecffbbb476d7dfb3ab09801e5c2218083dbb38b25136ba0a065f2a487f"),
        ("int32", (6, 9, 2),
         "dd2df1065eef8abdb88ea6a47cdfd35a9ea5e525e1ff87cff8ebc03d0e2cae20"),
        ("int32", (6, 9),
         "7acc7d2766b9d11734ca38040fdea0ae26ce946171d8645ea3255f591585bd01"),
        ("int32", (6, 9, 4),
         "8678bb299ebbe93ebd90184625636f4dd0a00ab08748e2909df785bf60e4039b"),
        ("float32", (6, 9),
         "6079a5cb3e51d55eeef44f2788300e896527943984577fc77735059b00b143fa"),
        ("int32", (6, 9, 3),
         "d88b149dc39a1567abbea3f5dcb09c2b88b7acd099b6376db8fa6c90c163a9e1"),
        ("int32", (6, 9, 2),
         "9607a9c1ffa6dc35a8ece453910bc7ed8ff78f977272ef93192000ca425c0205"),
        ("int32", (6, 9, 3, 4),
         "f1bc90389f6ee485a6a28ab4dee233fce18ddacda5ce99d90fa062492bedd741"),
        ("int32", (6, 9, 2),
         "82c0eccaca6d9349432da14f1234a0fcb36509fffc3c267318310b6f08a9c17d"),
        ("int32", (6, 9),
         "7acc7d2766b9d11734ca38040fdea0ae26ce946171d8645ea3255f591585bd01"),
        ("int32", (6, 9, 4),
         "8678bb299ebbe93ebd90184625636f4dd0a00ab08748e2909df785bf60e4039b"),
        ("float32", (6, 9),
         "b7d7eff104afff84944bfed5ed41cf6f9dedc50cc11c036f345e18fbde161f78"),
        ("int32", (6, 9, 3),
         "d21e28779d6075934b9c9c49840a6d14d93f32fd09f1fd46b501346398436545"),
        ("int32", (6, 9, 2),
         "c1ba6eb4e131486adfce107014e88652f71d49802b29fa41a2354b0291f310b0"),
        ("int32", (6, 9, 3, 4),
         "7658ecddb3892b887cfb3be6c39abab3c89a85258129ef4030f1afff959d58cf"),
        ("int32", (6, 9, 2),
         "32cdcaedfe81ac4ceb1f50010bc299a8e417c086bcccd3df1d2061c764a8b14d"),
        ("int32", (6, 9),
         "7acc7d2766b9d11734ca38040fdea0ae26ce946171d8645ea3255f591585bd01"),
        ("int32", (6, 9, 4),
         "8678bb299ebbe93ebd90184625636f4dd0a00ab08748e2909df785bf60e4039b"),
        ("float32", (6, 9),
         "294eccac445dc7d1f19b1365ea47e970a2600833aeb4e5fe1dfeb483b0c0ea29"),
        ("int32", (6, 9, 3),
         "c4b8d547348762862a120e478fa7f32c61812040ffaddb67bbd294c0066fdbc5"),
        ("int32", (6, 9, 2),
         "94b5a8430627874fbb8f3c5a661b58e6bc08516399a3e1aa0c00a8b7ead66e9c"),
        ("int32", (6, 9, 3, 4),
         "f1aad3e364aedaedc6e885ca234b36a245ede8f301563fa608c31401a1d270de"),
        ("int32", (6, 9, 2),
         "bc7fe6ec3e8473ad6d6b1a754bb74a3356a012a7289d107954e5d2d3d0c9a382"),
    ),
    "boxsum": (
        ("float32", (32, 48),
         "ee49282f4360069b58c744e27a04952694a796b6f8077eccd6efbe2bdfdb39f9"),
    ),
}
# -- records end --


def digest(arrays) -> tuple:
    """(dtype, shape, sha256 of the bytes) of each array."""
    out = []
    for a in arrays:
        a = np.ascontiguousarray(a)
        out.append((str(a.dtype), tuple(a.shape),
                    hashlib.sha256(a.tobytes()).hexdigest()))
    return tuple(out)


def _fma_rounded_twice(a, b, c):
    """The other model of gpu.encode._fma: a * b rounded to float32, then
    the sum with c rounded again (XLA capped at SSE4_2)."""
    def f32(x):
        return (x.to(torch.float32) if isinstance(x, torch.Tensor)
                else torch.tensor(np.float32(x)))
    return f32(a) * f32(b) + f32(c)


@contextlib.contextmanager
def _rounded_twice():
    """The port's functions with every _fma site rounded twice."""
    saved = genc._fma, gsao._fma
    genc._fma = gsao._fma = _fma_rounded_twice
    try:
        yield
    finally:
        genc._fma, gsao._fma = saved


# Each case computes its outputs (a list of arrays) by one of three means:
# "port" (the port's function), "jax" (the jitted JAX function in this
# process) or "model" (the other arithmetic: the port's function rounded
# twice, or the 2x2 windows summed pairwise)

def case_fma(kind: str) -> list:
    rng = np.random.default_rng(27)
    a = rng.random(4096).astype(np.float32) * 1e6
    b = np.float32(34.471443)
    c = rng.random(4096).astype(np.float32) * 300
    if kind == "jax":
        return [np.asarray(jax.jit(lambda a, b, c: a + b * c)(a, b, c))]
    if kind == "model":
        return [a + b * c]
    return [genc._fma(float(b), torch.from_numpy(c),
                      torch.from_numpy(a)).numpy()]


def case_rd_leaf_cost(kind: str, s: int, intra: bool) -> list:
    qp = 27
    rng = np.random.default_rng(1000 + 10 * s + int(intra))
    src = rng.integers(0, 256, (128, 192)).astype(np.int32)
    pred = np.clip(src + rng.integers(-40, 41, src.shape), 0, 255).astype(
        np.int32)
    sig = rng.integers(1, 20, (128 // s, 192 // s)).astype(np.int32)
    lam = float((genc._LAM_SSE_I if intra else genc._LAM_SSE_P)[qp])
    if kind == "jax":
        if intra:
            return [np.asarray(jax.jit(jenc._rd_leaf_cost_intra,
                                       static_argnums=(2, 5))(
                jnp.asarray(src), jnp.asarray(pred), s, jnp.int32(qp),
                jnp.float32(lam), 8))]
        return [np.asarray(jax.jit(jenc._rd_leaf_cost,
                                   static_argnums=(2, 6))(
            jnp.asarray(src), jnp.asarray(pred), s, jnp.int32(qp),
            jnp.float32(lam), jnp.asarray(sig), 8))]
    with _rounded_twice() if kind == "model" else contextlib.nullcontext():
        if intra:
            got = genc._rd_leaf_cost(torch.from_numpy(src),
                                     torch.from_numpy(pred), s, qp, lam, 4.0,
                                     8, is_intra=True)
        else:
            got = genc._rd_leaf_cost(torch.from_numpy(src),
                                     torch.from_numpy(pred), s, qp, lam,
                                     torch.from_numpy(sig), 8)
    return [got.numpy()]


def _tu(d, bits):
    """A 4x4 TU (bb, lv, r) whose reconstruction SSE is d and whose
    _tu_bits_est is bits (12 + 4 per level of 1, 6 for one level of 2)."""
    lv = np.zeros(16, np.int32)
    ones, two = ((bits - 12) // 4, 0) if bits % 4 == 0 else \
        ((bits - 18) // 4, 1)
    lv[:ones] = 1
    lv[ones:ones + two] = 2
    e = np.zeros(16, np.int32)
    for i in range(16):                 # greedy sum of squares
        e[i] = int(np.sqrt(d))
        d -= int(e[i]) ** 2
    assert d == 0
    bb = np.full(16, 40, np.int32)
    return bb.reshape(4, 4), lv.reshape(4, 4), (bb - e).reshape(4, 4)


def _near_ties(lam):
    """(bb, lv, r, lv2, r2) batches of 4x4 TUs whose two alternatives'
    costs D + lam * R compare one way with one rounding and the other way
    with two."""
    lam = np.float32(lam)
    d = np.arange(0, 30000)
    out = []
    for b in range(16, 77, 2):
        for b2 in range(16, 77, 2):
            d2 = d + int(round(float(lam) * (b - b2)))

            def order(two):
                def j(dd, bits):
                    if two:
                        return dd.astype(np.float32) + lam * np.float32(bits)
                    return (dd + np.float64(lam) * bits).astype(np.float32)
                return j(d2, b2) < j(d, b)
            hit = (d2 >= 0) & (order(True) != order(False))
            out += [(_tu(int(d[i]), b), _tu(int(d2[i]), b2))
                    for i in np.nonzero(hit)[0][:2]]
    return [np.stack([t[0][0] for t in out]),
            np.stack([t[0][1] for t in out]),
            np.stack([t[0][2] for t in out]),
            np.stack([t[1][1] for t in out]),
            np.stack([t[1][2] for t in out])]


@functools.lru_cache(maxsize=None)
def _tu_rd_args():
    lam = float(np.float32(genc._LAM_SSE_P[30]) * np.float32(1.5))
    return lam, _near_ties(lam)


def case_tu_rd_better(kind: str) -> list:
    """On TUs where one and two roundings pick different alternatives."""
    lam, args = _tu_rd_args()
    if kind == "jax":
        return [np.asarray(jax.jit(jenc._tu_rd_better)(
            *[jnp.asarray(a) for a in args], jnp.float32(lam)))]
    with _rounded_twice() if kind == "model" else contextlib.nullcontext():
        return [genc._tu_rd_better(*[torch.from_numpy(a) for a in args],
                                   lam).numpy()]


def _sao_inputs():
    rng = np.random.default_rng(31)
    ny, nx = 6, 9
    cnt = rng.integers(0, 300, (ny, nx, 32)).astype(np.int32)
    sm = (cnt * rng.integers(-9, 10, (ny, nx, 32))
          + rng.integers(-50, 51, (ny, nx, 32))).astype(np.int32)
    stats = []
    for _ in range(3):
        ec = rng.integers(0, 200, (ny, nx, 4, 5)).astype(np.int32)
        es = (ec * rng.integers(-8, 9, (ny, nx, 4, 5))).astype(np.int32)
        bc = rng.integers(0, 200, (ny, nx, 32)).astype(np.int32)
        bs = (bc * rng.integers(-8, 9, (ny, nx, 32))).astype(np.int32)
        stats.append(dict(eo_cnt=ec, eo_sum=es, bo_cnt=bc, bo_sum=bs))
    return cnt, sm, stats


def case_sao(kind: str) -> list:
    """_bo_offsets_gains' outputs, then sao_decide_dev's decisions (which
    read the edge-offset score; keys in sorted order), per QP."""
    cnt, sm, stats = _sao_inputs()
    out = []
    for qp in range(22, 40, 3):
        lam = float(genc._LAM_SSE_I[qp])
        if kind == "jax":
            out += [np.asarray(x) for x in jax.jit(
                jsao._bo_offsets_gains, static_argnums=(3,))(
                jnp.asarray(cnt), jnp.asarray(sm), jnp.float32(lam), 7)]
            dec = jax.jit(functools.partial(jsao.sao_decide_dev,
                                            bit_depth=8))(
                [{k: jnp.asarray(v) for k, v in s.items()} for s in stats],
                jnp.float32(lam))
            out += [np.asarray(dec[k]) for k in sorted(dec)]
            continue
        with (_rounded_twice() if kind == "model"
              else contextlib.nullcontext()):
            out += [x.numpy() for x in gsao._bo_offsets_gains(
                torch.from_numpy(cnt), torch.from_numpy(sm), lam, 7)]
            dec = gsao.sao_decide_dev(
                [{k: torch.from_numpy(v) for k, v in s.items()}
                 for s in stats], lam)
        out += [dec[k].numpy() for k in sorted(dec)]
    return out


def case_boxsum(kind: str) -> list:
    """Float32 2x2 block sums of non-integer costs."""
    rng = np.random.default_rng(28)
    m = (rng.random((64, 96)) * 10 ** rng.integers(1, 5, (64, 96))).astype(
        np.float32)
    if kind == "jax":
        return [np.asarray(jax.jit(jenc._boxsum, static_argnums=1)(
            jnp.asarray(m), 2))]
    if kind == "model":
        return [(m[0::2, 0::2] + m[0::2, 1::2])
                + (m[1::2, 0::2] + m[1::2, 1::2])]
    return [genc._boxsum(torch.from_numpy(m), 2).numpy()]


# name -> (case, the probe that says whether this process's compile has
# the reference arithmetic at the case's sites)
CASES = {"fma": (case_fma, "multiply_add")}
CASES.update({f"rd_leaf_cost/{intra}-{s}": (
    functools.partial(case_rd_leaf_cost, s=s, intra=intra), "multiply_add")
    for intra in (False, True) for s in (8, 16, 32, 64)})
CASES.update({"tu_rd_better": (case_tu_rd_better, "multiply_add"),
              "sao": (case_sao, "multiply_add"),
              "boxsum": (case_boxsum, "2x2")})
PROBES = {"multiply_add": xla_contracts_multiply_add,
          "2x2": xla_sums_2x2_row_by_row}


@functools.lru_cache(maxsize=None)
def reference_arithmetic(probe: str) -> bool:
    """Whether the JAX graphs compiled in this process have the reference
    arithmetic at the sites the probe names."""
    return PROBES[probe]()


def _held(name: str) -> None:
    """The port's output == the record; the JAX output in this process ==
    the record under the reference arithmetic, else == the other model."""
    case, probe = CASES[name]
    assert digest(case("port")) == RECORDS[name], \
        f"{name}: the port's output is not the recorded reference"
    got = digest(case("jax"))
    if reference_arithmetic(probe):
        assert got == RECORDS[name], \
            f"{name}: the reference compile's JAX output is not the record"
    else:
        assert got == digest(case("model")), \
            f"{name}: this compile's JAX output is not the other model's"


def test_fma_is_xla_multiply_add():
    _held("fma")
    # and the two-rounding form is not the reference
    assert digest(case_fma("model")) != RECORDS["fma"]


@pytest.mark.parametrize("s", [8, 16, 32, 64])
@pytest.mark.parametrize("intra", [False, True])
def test_rd_leaf_cost_matches_jitted_jax(s, intra):
    name = f"rd_leaf_cost/{intra}-{s}"
    _held(name)
    # the inter costs' inputs separate the two arithmetics
    if not intra:
        assert digest(case_rd_leaf_cost("model", s, intra)) != RECORDS[name]


def test_tu_rd_better_matches_jitted_jax():
    """On TUs where one and two roundings pick different alternatives."""
    assert len(_tu_rd_args()[1][0]) > 0
    _held("tu_rd_better")
    assert digest(case_tu_rd_better("model")) != RECORDS["tu_rd_better"]


def test_tu_tree_dp_matches_jitted_jax():
    rng = np.random.default_rng(29)
    h, w = 64, 128
    res = rng.integers(-80, 81, (h, w)).astype(np.int32)
    rr = {lg: (res - rng.integers(-6, 7, (h, w))).astype(np.int32)
          for lg in (3, 4, 5)}
    lv = {lg: rng.integers(-2, 3, (h, w)).astype(np.int32)
          for lg in (3, 4, 5)}
    cu = rng.choice([4, 5, 6], (h // 8, w // 8)).astype(np.int32)
    inter = np.ones((h // 8, w // 8), bool)
    cap = np.minimum(cu, 5).astype(np.int32)
    for qp in range(22, 40):
        lam = float(np.float32(genc._LAM_SSE_P[qp]) * np.float32(1.5))
        want = jax.jit(jenc._tu_tree_dp)(
            jnp.asarray(res), {k: jnp.asarray(v) for k, v in rr.items()},
            {k: jnp.asarray(v) for k, v in lv.items()}, jnp.asarray(cu),
            jnp.asarray(inter), jnp.asarray(cap), jnp.float32(lam))
        got = genc._tu_tree_dp(
            torch.from_numpy(res),
            {k: torch.from_numpy(v) for k, v in rr.items()},
            {k: torch.from_numpy(v) for k, v in lv.items()},
            torch.from_numpy(cu), torch.from_numpy(inter),
            torch.from_numpy(cap), lam)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_sao_scores_match_jitted_jax():
    """_bo_offsets_gains' score bit for bit, and sao_decide_dev's
    decisions (which read the edge-offset score) on random statistics."""
    _held("sao")


def test_boxsum_f32_is_xla_2x2_order():
    """Float32 2x2 block sums of non-integer costs, bit for bit."""
    _held("boxsum")
    # and the pairwise order is not the reference
    assert digest(case_boxsum("model")) != RECORDS["boxsum"]


def test_split_dp_qp27_ctb_matches_jitted_jax():
    """decide_tree_dev on the port's own inputs at CTB (10, 4) of P picture
    22 of BD_r05_1080p_ipp.json's clip at qp 27 (CTB 64, M7), cropped to
    that CTB: the 16x16 CU at (16, 32) in it ties with its four 8x8
    children in the pairwise sum and splits in XLA's order."""
    z = np.load(QP27_CTB)
    md = {k: z[k].astype(np.int32) for k in
          ("mv8", "mv16", "mv32", "mv64", "sad8", "sad16", "sad32",
           "sad64", "zsad8")}
    src, ref = z["src_y"].astype(np.int32), z["ref_y"].astype(np.int32)
    qp, tb, td = int(z["qp"]), int(z["tb"]), int(z["td"])
    h, w = src.shape
    want = jax.jit(functools.partial(
        jenc.decide_tree_dev, ctb_log2=6, min_intra_log2=6, w=w, h=h,
        bit_depth=8))(
        {k: jnp.asarray(v) for k, v in md.items()}, {}, qp=jnp.int32(qp),
        src=jnp.asarray(src), ref=jnp.asarray(ref),
        col_mv8=jnp.asarray(z["col_mv"].astype(np.int32)),
        col_valid8=jnp.asarray(z["col_valid"]), tb=jnp.int32(tb),
        td=jnp.int32(td))
    got = genc.decide_tree_dev(
        {k: torch.from_numpy(v) for k, v in md.items()}, {}, 6,
        min_intra_log2=6, w=w, h=h, qp=qp, src=torch.from_numpy(src),
        ref=torch.from_numpy(ref), bit_depth=8,
        col_mv8=torch.from_numpy(z["col_mv"].astype(np.int32)),
        col_valid8=torch.from_numpy(z["col_valid"]), tb=tb, td=td)
    for g, w_ in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w_))
    assert (got[0][4:6, 2:4] == 3).all()


def _worker(path: str) -> None:
    """Every case's JAX outputs, and the probes, in this process's
    compile, saved to path."""
    jax.config.update("jax_platforms", "cpu")
    out = {f"probe/{p}": np.asarray(f()) for p, f in PROBES.items()}
    for name, (case, _) in CASES.items():
        for i, a in enumerate(case("jax")):
            out[f"{name}/{i}"] = a
    np.savez(path, **out)


def _format(records: dict) -> str:
    lines = ["RECORDS = {"]
    for name, outs in records.items():
        lines.append(f'    "{name}": (')
        for dt, shape, sha in outs:
            lines.append(f'        ("{dt}", {shape!r},')
            lines.append(f'         "{sha}"),')
        lines.append("    ),")
    lines.append("}")
    return "\n".join(lines)


def record() -> int:
    """Compute every case's JAX outputs under the reference compile (a
    subprocess: the compile cache off, no ISA cap) and rewrite RECORDS."""
    vals = run_worker(os.path.abspath(__file__), "default")
    if not all(vals[f"probe/{p}"] for p in PROBES):
        print("refused: this host's default compile does not have the "
              "reference arithmetic (an AVX-512 host's)", file=sys.stderr)
        return 1
    records = {}
    for name in CASES:
        outs = [vals[k] for k in sorted(
            (k for k in vals if k.startswith(name + "/")),
            key=lambda k: int(k.rsplit("/", 1)[1]))]
        records[name] = digest(outs)
        same = digest(CASES[name][0]("port")) == records[name]
        print(f"{name}: {len(outs)} outputs, the port's "
              f"{'equal' if same else 'DIFFERENT'}")
    path = os.path.abspath(__file__)
    with open(path) as f:
        text = f.read()
    text = re.sub(r"(# -- records begin --\n).*?(\n# -- records end --)",
                  lambda m: m.group(1) + _format(records) + m.group(2),
                  text, count=1, flags=re.S)
    with open(path, "w") as f:
        f.write(text)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--worker", metavar="OUT_NPZ")
    ap.add_argument("--record", action="store_true")
    args = ap.parse_args(argv)
    if args.worker:
        _worker(args.worker)
        return 0
    if args.record:
        return record()
    ap.print_help()
    return 2


if __name__ == "__main__":
    sys.exit(main())
