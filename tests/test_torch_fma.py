"""The fused multiply-adds of the jitted JAX graphs, in the port.

XLA:CPU contracts a float32 product that feeds an add or a subtract in
the same fusion into one multiply-add (one rounding); eager PyTorch
rounds the product and the sum apart. Where the product is not an
integer the two differ in the last bit, and a cost that decides between
two near-equal candidates can then pick the other one: at CTB 64 and qp
27 the 1080p clip of BD_r05_1080p_ipp.json came out 6 bytes off the JAX
package's stream. The port computes those costs with gpu.encode._fma
(float64 product and sum, rounded to float32 once). The sites are the
f32 multiply -> add pairs inside the fusions of the jitted fused-path
graphs (_fast_p_front / _fast_p_finish / _fast_b_front / _fast_b_finish /
fast_i_fused_dev): _rd_leaf_cost (and its intra form), _tu_rd_better,
_tu_tree_dp and the two SAO scores; the others there add integer-valued
products, which are exact either way. Each is held bit for bit against
the jitted JAX function here.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svt_hevc_tpu.tpu import encode as jenc
from svt_hevc_tpu.tpu import sao as jsao
from svt_hevc_tpu_torch.gpu import encode as genc
from svt_hevc_tpu_torch.gpu import sao as gsao
from tests.test_torch_encoder import one_torch_thread  # noqa: F401

RNG = np.random.default_rng(27)


def test_fma_is_xla_multiply_add():
    a = RNG.random(4096).astype(np.float32) * 1e6
    b = np.float32(34.471443)
    c = RNG.random(4096).astype(np.float32) * 300
    want = np.asarray(jax.jit(lambda a, b, c: a + b * c)(a, b, c))
    got = genc._fma(float(b), torch.from_numpy(c), torch.from_numpy(a))
    np.testing.assert_array_equal(got.numpy(), want)
    # and the two-rounding form is not what XLA computes
    assert not np.array_equal(a + b * c, want)


@pytest.mark.parametrize("s", [8, 16, 32, 64])
@pytest.mark.parametrize("intra", [False, True])
def test_rd_leaf_cost_matches_jitted_jax(s, intra):
    qp = 27
    src = RNG.integers(0, 256, (128, 192)).astype(np.int32)
    pred = np.clip(src + RNG.integers(-40, 41, src.shape), 0, 255).astype(
        np.int32)
    sig = RNG.integers(1, 20, (128 // s, 192 // s)).astype(np.int32)
    if intra:
        lam = float(genc._LAM_SSE_I[qp])
        want = jax.jit(jenc._rd_leaf_cost_intra, static_argnums=(2, 5))(
            jnp.asarray(src), jnp.asarray(pred), s, jnp.int32(qp),
            jnp.float32(lam), 8)
        got = genc._rd_leaf_cost(torch.from_numpy(src),
                                 torch.from_numpy(pred), s, qp, lam, 4.0, 8,
                                 is_intra=True)
    else:
        lam = float(genc._LAM_SSE_P[qp])
        want = jax.jit(jenc._rd_leaf_cost, static_argnums=(2, 6))(
            jnp.asarray(src), jnp.asarray(pred), s, jnp.int32(qp),
            jnp.float32(lam), jnp.asarray(sig), 8)
        got = genc._rd_leaf_cost(torch.from_numpy(src),
                                 torch.from_numpy(pred), s, qp, lam,
                                 torch.from_numpy(sig), 8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


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


def test_tu_rd_better_matches_jitted_jax():
    """On TUs where one and two roundings pick different alternatives."""
    lam = float(np.float32(genc._LAM_SSE_P[30]) * np.float32(1.5))
    args = _near_ties(lam)
    assert len(args[0]) > 0
    want = np.asarray(jax.jit(jenc._tu_rd_better)(
        *[jnp.asarray(a) for a in args], jnp.float32(lam)))
    got = genc._tu_rd_better(*[torch.from_numpy(a) for a in args], lam)
    np.testing.assert_array_equal(got.numpy(), want)


def test_tu_tree_dp_matches_jitted_jax():
    h, w = 64, 128
    res = RNG.integers(-80, 81, (h, w)).astype(np.int32)
    rr = {lg: (res - RNG.integers(-6, 7, (h, w))).astype(np.int32)
          for lg in (3, 4, 5)}
    lv = {lg: RNG.integers(-2, 3, (h, w)).astype(np.int32)
          for lg in (3, 4, 5)}
    cu = RNG.choice([4, 5, 6], (h // 8, w // 8)).astype(np.int32)
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
    ny, nx = 6, 9
    cnt = RNG.integers(0, 300, (ny, nx, 32)).astype(np.int32)
    sm = (cnt * RNG.integers(-9, 10, (ny, nx, 32))
          + RNG.integers(-50, 51, (ny, nx, 32))).astype(np.int32)
    for qp in range(22, 40, 3):
        lam = float(genc._LAM_SSE_I[qp])
        want = jax.jit(jsao._bo_offsets_gains, static_argnums=(3,))(
            jnp.asarray(cnt), jnp.asarray(sm), jnp.float32(lam), 7)
        got = gsao._bo_offsets_gains(torch.from_numpy(cnt),
                                     torch.from_numpy(sm), lam, 7)
        for g, w_ in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w_))
    stats = []
    for _ in range(3):
        ec = RNG.integers(0, 200, (ny, nx, 4, 5)).astype(np.int32)
        es = (ec * RNG.integers(-8, 9, (ny, nx, 4, 5))).astype(np.int32)
        bc = RNG.integers(0, 200, (ny, nx, 32)).astype(np.int32)
        bs = (bc * RNG.integers(-8, 9, (ny, nx, 32))).astype(np.int32)
        stats.append(dict(eo_cnt=ec, eo_sum=es, bo_cnt=bc, bo_sum=bs))
    for qp in range(22, 40, 3):
        lam = float(genc._LAM_SSE_I[qp])
        want = jax.jit(functools.partial(jsao.sao_decide_dev, bit_depth=8))(
            [{k: jnp.asarray(v) for k, v in s.items()} for s in stats],
            jnp.float32(lam))
        got = gsao.sao_decide_dev(
            [{k: torch.from_numpy(v) for k, v in s.items()} for s in stats],
            lam)
        for k in want:
            np.testing.assert_array_equal(got[k].numpy(),
                                          np.asarray(want[k]), err_msg=k)
