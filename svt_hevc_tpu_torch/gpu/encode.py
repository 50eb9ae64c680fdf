"""Encode pass on the card: the EncDec hot loop as batched PyTorch stages.

PyTorch port of the I-, P- and B-picture fused paths of
svt_hevc_tpu/tpu/encode.py: dense mode decision, quadtree decision,
merge alignment, the normative inter encode pass, the in-loop filters and
the packed download. Function names and layouts follow the JAX module so
each counterpart is easy to find.

Conventions of the port:
  - Per-block motion compensation goes through kernel K2
    (gpu/kernels.mc_block) via _mc_luma / _mc_chroma. Independent MV
    fields on one reference go into one launch (a (K, nby, nbx, 2) field
    stack), and so do Cb and Cr; no decision is reordered for it. B
    pictures launch once per reference plane: two lists under different
    fields are two launches.
  - Scalars the JAX graphs carry as traced values (qp, qp_c, tb, td) are
    Python ints here, and float32 lambdas are Python floats holding a
    float32 value, so no per-scalar device round trip exists.
  - Integer matrix products (the DCT stages, the Hadamard SATD) run as
    float64 matmuls: every sum stays far below 2^53, so they are exact on
    the CPU and on the card alike (the card has no int32 matmul).
  - Sums of integer-valued planes that JAX forms in float32 are taken
    exactly (int64) and converted to float32 once, and 2x2 sums of
    non-integer costs are taken in one fixed order, so the CPU and the
    card give the same bits.
  - Out-of-range indices are clamped explicitly wherever JAX clamped them
    silently.
"""

from __future__ import annotations

import contextlib
import functools

import numpy as np
import torch

from .. import trace
from .chain_script import recorder
from ..core.inter import CHROMA_FILTERS, LUMA_FILTERS
from ..core.quant import INV_QUANT_SCALES, QUANT_SCALES
from ..core.transforms import DCT
from .dlf import _POC_NONE
from .kernels import edge_pad, mc_block, mc_block_ref

# full-pel MV headroom on each side of the coded picture (see the JAX
# module: decided MVs are clamped to +/-(PAD-9) full-pel so every
# interpolation window stays inside the extended planes)
PAD = 64

_LUMA_F = np.stack([np.asarray(LUMA_FILTERS[p], np.int32) for p in range(4)])
_CHROMA_F = np.stack([np.asarray(CHROMA_FILTERS[p], np.int32)
                      for p in range(8)])

# ------------------------------------------------------------- constants
#
# The decision constants of the reference at their default values (the
# port reads no environment variables).

# the P fast path offers intra only at 16/32 by default
P_MIN_INTRA_LOG2 = 4
# extra lambda weight on the INTER residual zero-out
INTER_ZERO_LAMBDA_SCALE = 1.5
# inter-slice MD lambda weight over the I-slice SSE base
P_LAMBDA_SCALE = 1.5
# stage-2 bias (bits, lambda-scaled) toward the merge-class candidate
MERGE_BIAS_BITS = 8.0
# signalling charge of the AMVP-coded candidate on top of its MVD bits
AMVP_BASE_BITS = 4
# merge-index charge of the TMVP (collocated) candidate
TMVP_BITS = 5
# MV-rate weight inside the dense search (units of the SAD lambda)
ME_LAMBDA_SCALE = 1
# merge-snap preference (bits, SATD-lambda-scaled)
SNAP_BIAS_BITS = 4
# merge-snap passes over the decided field
SNAP_PASSES = 3
# sparse-download occupancy cap: cap = n_groups // COMPACT_CAP_FRAC
COMPACT_CAP_FRAC = 4

# SAD-domain lambda per QP (HM-style sqrt(0.85 * 2^((qp-12)/3)), rounded)
LAMBDA_SAD = np.maximum(
    np.round(np.sqrt(0.85 * 2.0 ** ((np.arange(64) - 12) / 3.0))),
    1).astype(np.int32)

# float32 SSE-domain lambdas per QP, bit for bit as the reference graphs
# evaluate them: I-slice 0.57 * 2^((qp-12)/3) and the P-slice value
# P_LAMBDA_SCALE * 0.57 * 2^((qp-12)/3). Tabulated rather than recomputed
# because exp2 implementations differ in the last bit of float32, and a
# decision compares against these values.
_LAM_SSE_I = np.array([
    0.035625, 0.04488469, 0.056551162, 0.07125, 0.08976938, 0.113102324,
    0.1425, 0.17953876, 0.22620465, 0.285, 0.3590775, 0.4524093, 0.57,
    0.718155, 0.9048186, 1.14, 1.43631, 1.8096372, 2.28, 2.87262,
    3.6192744, 4.56, 5.74524, 7.2385488, 9.12, 11.49048, 14.4770975, 18.24,
    22.98096, 28.954195, 36.48, 45.96192, 57.90839, 72.96, 91.92384,
    115.81678, 145.92, 183.84769, 231.63356, 291.84, 367.69537, 463.26712,
    583.68, 735.39075, 926.53424, 1167.36, 1470.7815, 1853.0695, 2334.72,
    2941.5615, 3706.1372, 4669.4424], np.float32)
_LAM_SSE_P = np.array([
    0.0534375, 0.06732704, 0.084826745, 0.106875, 0.13465407, 0.16965349,
    0.21375, 0.26930815, 0.33930698, 0.4275, 0.5386163, 0.67861396, 0.855,
    1.0772326, 1.3572279, 1.71, 2.1544652, 2.7144558, 3.42, 4.3089304,
    5.4289117, 6.84, 8.617861, 10.857823, 13.68, 17.235722, 21.715647,
    27.36, 34.471443, 43.431293, 54.72, 68.94289, 86.86259, 109.44,
    137.88577, 173.72517, 218.88, 275.77155, 347.45035, 437.76, 551.5431,
    694.9007, 875.52, 1103.0862, 1389.8014, 1751.04, 2206.1724, 2779.6042,
    3502.08, 4412.3423, 5559.206, 7004.1636], np.float32)

# Per-stage hook of the picture pipelines, None by default: an object
# whose stage(name) is a context manager, entered around every stage
# outside the tracer's span (the benchmark's two stage timers set it).
STAGE_TIMER = None

# Fused P chains run through PChainScripts (gpu/chain_script.py), those
# whose outputs came from replaying a recorded script, and scripts
# recorded, since the caller last zeroed them: graph_runs / runs is the
# share of P pictures replayed (0 on the CPU).
PCHAIN = {"runs": 0, "graph_runs": 0, "captures": 0}


def stage(name: str, wait: bool = False):
    """Context of one named stage ("p.dense_md_p", "i.download", ...): a
    span of the running trace.Tracer, inside STAGE_TIMER's stage where the
    hook is set. wait: the host blocks on the device inside it. While a
    P-chain script is recorded on this thread, a mark of the script
    instead (its spans are entered when the script is replayed)."""
    rec = recorder()
    if rec is not None:
        return rec.mark(name, wait)
    t = STAGE_TIMER
    if t is None:
        return trace.span(name, wait)
    return _hooked(t, name, wait)


@contextlib.contextmanager
def _hooked(timer, name: str, wait: bool):
    with timer.stage(name), trace.span(name, wait):
        yield


def _f32(x) -> float:
    """A Python float holding the float32 rounding of x."""
    return float(np.float32(x))


@functools.lru_cache(maxsize=None)
def _dev_table(name: str, device: str, arg: int = 0) -> torch.Tensor:
    """Constant tables on a device, built once per device."""
    if name == "dct":
        a = DCT[arg].astype(np.float64)
    elif name == "had8":
        h = np.array([[1.0]])
        while h.shape[0] < 8:
            h = np.block([[h, h], [h, -h]])
        a = h
    elif name == "pow2":
        a = (1 << np.arange(arg)).astype(np.int64)
    else:
        raise KeyError(name)
    return torch.as_tensor(a).to(device)


def _rep(m: torch.Tensor, k: int) -> torch.Tensor:
    """jnp.repeat(jnp.repeat(m, k, 0), k, 1)."""
    if k == 1:
        return m
    return m.repeat_interleave(k, 0).repeat_interleave(k, 1)


def _edge_pad(p: torch.Tensor, n: int) -> torch.Tensor:
    return edge_pad(p, n)


def _imm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact integer matrix product via float64 (operands hold integers,
    every sum is far below 2^53). Returns int64."""
    return torch.matmul(a.to(torch.float64), b.to(torch.float64)).to(
        torch.int64)


def _fma(a, b, c):
    """float32 a * b + c rounded once, as XLA:CPU computes the product-
    plus-addend it fuses into one multiply-add (jitted JAX graphs do;
    eager PyTorch rounds the product and the sum apart). The product of
    two float32 values is exact in float64."""
    def f64(x):
        return (x.to(torch.float64) if isinstance(x, torch.Tensor)
                else float(np.float32(x)))
    return (f64(a) * f64(b) + f64(c)).to(torch.float32)


def _isum_f32(m: torch.Tensor, dims) -> torch.Tensor:
    """Exact sum of an integer tensor over dims, as float32."""
    return m.to(torch.int64).sum(dim=dims).to(torch.float32)


# ------------------------------------------------------------- phase planes

def luma_phase_planes(ref: torch.Tensor, bit_depth: int = 8) -> torch.Tensor:
    """All 16 quarter-pel interpolations of a luma plane, 14-bit domain:
    (4, 4, H+2*PAD, W+2*PAD) int32 indexed [fy][fx]."""
    shift1 = bit_depth - 8
    ext = _edge_pad(ref.to(torch.int32), PAD + 4)
    hp, wp = ref.shape[0] + 2 * PAD, ref.shape[1] + 2 * PAD
    hx = []
    for fx in range(4):
        acc = torch.zeros((hp + 8, wp), dtype=torch.int32, device=ref.device)
        for k in range(8):
            acc = acc + int(_LUMA_F[fx, k]) * ext[:, 1 + k:1 + k + wp]
        hx.append(acc >> shift1)
    planes = []
    for fy in range(4):
        row = []
        for h in hx:
            acc = torch.zeros((hp, wp), dtype=torch.int32, device=ref.device)
            for k in range(8):
                acc = acc + int(_LUMA_F[fy, k]) * h[1 + k:1 + k + hp]
            row.append(acc >> 6)
        planes.append(torch.stack(row))
    return torch.stack(planes)


def chroma_phase_planes(ref: torch.Tensor,
                        bit_depth: int = 8) -> torch.Tensor:
    """All 64 eighth-pel interpolations of a chroma plane (4:2:0), 14-bit
    domain: (8, 8, Hc+PAD, Wc+PAD) int32 indexed [fy][fx]; the chroma pad
    is PAD/2 (a chroma MV offset is mv>>3 of a quarter-luma-pel MV)."""
    shift1 = bit_depth - 8
    padc = PAD // 2
    ext = _edge_pad(ref.to(torch.int32), padc + 2)
    hp, wp = ref.shape[0] + 2 * padc, ref.shape[1] + 2 * padc
    hx = []
    for fx in range(8):
        acc = torch.zeros((hp + 4, wp), dtype=torch.int32, device=ref.device)
        for k in range(4):
            acc = acc + int(_CHROMA_F[fx, k]) * ext[:, 1 + k:1 + k + wp]
        hx.append(acc >> shift1)
    planes = []
    for fy in range(8):
        row = []
        for h in hx:
            acc = torch.zeros((hp, wp), dtype=torch.int32, device=ref.device)
            for k in range(4):
                acc = acc + int(_CHROMA_F[fy, k]) * h[1 + k:1 + k + hp]
            row.append(acc >> 6)
        planes.append(torch.stack(row))
    return torch.stack(planes)


# ----------------------------------------------- phase-plane MC (gathers)
#
# The phase-plane form of motion compensation: every fractional
# interpolation of the reference is made up front (luma_phase_planes /
# chroma_phase_planes) and a prediction is a gather of whole blocks from
# those planes. It is what fast_p_fused_packed (and so
# parallel.mesh.gop_encode_step) runs; the encoder's fused paths use the
# per-block form through K2 instead. Gathers, not kernels: plain tensor
# indexing.

def _take_index(idx: torch.Tensor, size: int) -> torch.Tensor:
    """An index as a jnp gather reads it: a negative index counts from the
    end, then the index is clamped into [0, size)."""
    idx = idx.long()
    return torch.where(idx < 0, idx + size, idx).clamp(0, size - 1)


def _gather_blocks(planes: torch.Tensor, ph: torch.Tensor, sy: torch.Tensor,
                   sx: torch.Tensor, n: int, h: int, w: int) -> torch.Tensor:
    """(n, n) blocks gathered from a (P, Hp, Wp) phase-plane stack into an
    (h, w) plane. ph/sy/sx: per-block phase index and top-left coords in
    the padded planes, shape (h//n, w//n)."""
    p_, hp, wp = planes.shape
    a = torch.arange(n, device=planes.device)
    out = planes[_take_index(ph[:, :, None, None], p_),
                 _take_index(sy[:, :, None, None] + a[None, None, :, None],
                             hp),
                 _take_index(sx[:, :, None, None] + a[None, None, None, :],
                             wp)]
    return out.permute(0, 2, 1, 3).reshape(h, w)


def _luma_gather_args(raw: torch.Tensor, mv8: torch.Tensor):
    """(phase, sy, sx, h, w) of a luma gather from (4, 4, Hp, Wp)."""
    hp, wp = raw.shape[2], raw.shape[3]
    h, w = hp - 2 * PAD, wp - 2 * PAD
    mvx, mvy = mv8[..., 0].to(torch.int32), mv8[..., 1].to(torch.int32)
    dev = raw.device
    by = torch.arange(h // 8, device=dev) * 8
    bx = torch.arange(w // 8, device=dev) * 8
    return ((mvy & 3) * 4 + (mvx & 3), by[:, None] + (mvy >> 2) + PAD,
            bx[None, :] + (mvx >> 2) + PAD, h, w)


def _chroma_gather_args(raw: torch.Tensor, mv8: torch.Tensor):
    """(phase, sy, sx, h, w) of a chroma gather from (8, 8, Hcp, Wcp)."""
    hp, wp = raw.shape[2], raw.shape[3]
    padc = PAD // 2
    h, w = hp - 2 * padc, wp - 2 * padc
    mvx, mvy = mv8[..., 0].to(torch.int32), mv8[..., 1].to(torch.int32)
    dev = raw.device
    by = torch.arange(h // 4, device=dev) * 4
    bx = torch.arange(w // 4, device=dev) * 4
    return ((mvy & 7) * 8 + (mvx & 7), by[:, None] + (mvy >> 3) + padc,
            bx[None, :] + (mvx >> 3) + padc, h, w)


def _mc_gather_raw_luma(raw: torch.Tensor, mv8: torch.Tensor) -> torch.Tensor:
    """Luma MC gather in the 14-bit intermediate domain (no rounding): the
    bi-prediction input form. raw: (4, 4, Hp, Wp) phase planes; mv8:
    (nby, nbx, 2) quarter-pel [mvx, mvy] per 8x8 block."""
    ph, sy, sx, h, w = _luma_gather_args(raw, mv8)
    return _gather_blocks(raw.reshape(16, *raw.shape[2:]), ph, sy, sx, 8,
                          h, w)


def _mc_gather_raw_chroma(raw: torch.Tensor,
                          mv8: torch.Tensor) -> torch.Tensor:
    """Chroma (4:2:0) MC gather in the 14-bit domain: per-8x8-luma-block
    MV -> per-4x4 chroma block from the (8, 8, Hcp, Wcp) phase planes."""
    ph, sy, sx, h, w = _chroma_gather_args(raw, mv8)
    return _gather_blocks(raw.reshape(64, *raw.shape[2:]), ph, sy, sx, 4,
                          h, w)


def mc_pred_luma(raw: torch.Tensor, mv8: torch.Tensor,
                 bit_depth: int = 8) -> torch.Tensor:
    """Uni-pred luma plane from the (4, 4, Hp, Wp) phase planes and a
    per-8x8-block quarter-pel MV field (nby, nbx, 2) [mvx, mvy]."""
    return _round_uni(_mc_gather_raw_luma(raw, mv8), bit_depth)


def mc_pred_chroma(raw: torch.Tensor, mv8: torch.Tensor,
                   bit_depth: int = 8) -> torch.Tensor:
    """Uni-pred chroma plane (4:2:0) from the (8, 8, Hcp, Wcp) phase
    planes and the per-8x8-luma-block MV field."""
    return _round_uni(_mc_gather_raw_chroma(raw, mv8), bit_depth)


# ------------------------------------------------------- per-block MC (K2)

def _ext_y(ref: torch.Tensor) -> torch.Tensor:
    """Edge-padded luma plane for direct MC (PAD+4 per side)."""
    return _edge_pad(ref.to(torch.int32), PAD + 4)


def _ext_c(ref_c: torch.Tensor) -> torch.Tensor:
    """Edge-padded chroma plane for direct MC (PAD//2+2 per side)."""
    return _edge_pad(ref_c.to(torch.int32), PAD // 2 + 2)


def _luma_maps(mv8):
    mvx, mvy = mv8[..., 0], mv8[..., 1]
    return (mvy >> 2) + PAD + 1, (mvx >> 2) + PAD + 1, mvx & 3, mvy & 3


def _chroma_maps(mv8):
    mvx, mvy = mv8[..., 0], mv8[..., 1]
    return ((mvy >> 3) + PAD // 2 + 1, (mvx >> 3) + PAD // 2 + 1,
            mvx & 7, mvy & 7)


def _mc_raw_luma_direct(ref_ext, mv8, bit_depth: int = 8):
    """Luma MC in the 14-bit intermediate domain (the plain form)."""
    return mc_block_ref(ref_ext, *_luma_maps(mv8), 8, 8, PAD, False,
                        bit_depth)


def _mc_pred_luma_direct(ref_ext, mv8, bit_depth: int = 8):
    return mc_block_ref(ref_ext, *_luma_maps(mv8), 8, 8, PAD, True,
                        bit_depth)


def _mc_raw_chroma_direct(ref_c_ext, mv8, bit_depth: int = 8):
    return mc_block_ref(ref_c_ext, *_chroma_maps(mv8), 4, 4, PAD // 2,
                        False, bit_depth)


def _mc_pred_chroma_direct(ref_c_ext, mv8, bit_depth: int = 8):
    return mc_block_ref(ref_c_ext, *_chroma_maps(mv8), 4, 4, PAD // 2,
                        True, bit_depth)


def _mc_luma(ref_ext, mv8, bit_depth: int, rounded: bool):
    """Per-8x8-block luma MC from the (PAD+4)-padded integer reference
    through kernel K2. MVs are clamped to the padded reach first, so every
    window lies inside ref_ext. mv8 is one field (nby, nbx, 2) -> (h, w),
    or K fields (K, nby, nbx, 2) -> (K, h, w) in one launch."""
    lim = (PAD - 9) * 4
    mv8 = mv8.to(torch.int32).clamp(-lim, lim)
    return mc_block(ref_ext, *_luma_maps(mv8), 8, 8, PAD, rounded,
                    bit_depth)


def _mc_chroma(ref_c_ext, mv8, bit_depth: int, rounded: bool):
    """Per-4x4-block chroma MC (4:2:0) from the (PAD//2+2)-padded plane
    through kernel K2; ref_c_ext may hold both planes, (2, hp, wp) ->
    (2, h, w) in one launch."""
    lim = (PAD - 9) * 4
    mv8 = mv8.to(torch.int32).clamp(-lim, lim)
    return mc_block(ref_c_ext, *_chroma_maps(mv8), 4, 4, PAD // 2, rounded,
                    bit_depth)


# ------------------------------------------------------------ dense T/Q/IQ/IT

def _blocks(plane: torch.Tensor, n: int) -> torch.Tensor:
    h, w = plane.shape
    return (plane.reshape(h // n, n, w // n, n)
            .permute(0, 2, 1, 3).reshape(-1, n, n))


def _unblocks(b: torch.Tensor, n: int, h: int, w: int) -> torch.Tensor:
    return (b.reshape(h // n, w // n, n, n)
            .permute(0, 2, 1, 3).reshape(h, w))


def _bit_length(a: torch.Tensor, nbits: int) -> torch.Tensor:
    """(a[..., None] >= (1 << arange(nbits))).sum(-1) for a >= 0."""
    p = _dev_table("pow2", str(a.device), nbits)
    return (a[..., None] >= p).sum(-1, dtype=torch.int32)


def _tu_vbits_groups(lv: torch.Tensor):
    n = lv.shape[-1]
    a = lv.abs()
    blen = _bit_length(a, 15)
    vbits = torch.where(a > 0, 2 + 2 * blen, 0).to(torch.int64).sum(
        (-2, -1)).to(torch.float32)
    if n >= 8:
        g = a.reshape(*a.shape[:-2], n // 4, 4, n // 4, 4).sum((-3, -1))
        ngroups = (g > 0).sum((-2, -1)).to(torch.float32)
    else:
        ngroups = (a.sum((-2, -1)) > 0).to(torch.float32)
    return vbits, ngroups


def _tu_zero_rd(bb, lv, r, lam):
    """Per-TU RD zero-out: kill a TU's coefficients when coding them buys
    less SSE than lambda * (estimated coefficient bits)."""
    d0 = _isum_f32(bb * bb, (-2, -1))
    dr = bb - r
    d1 = _isum_f32(dr * dr, (-2, -1))
    vbits, ngroups = _tu_vbits_groups(lv)
    bits = vbits + 7.0 * ngroups + 12.0
    keep = ((d0 - d1) >= lam * bits)[..., None, None]
    return torch.where(keep, lv, 0), torch.where(keep, r, 0)


def _tu_bits_est(lv):
    """Per-TU coefficient-bit estimate of a (B, n, n) levels batch."""
    vbits, ngroups = _tu_vbits_groups(lv)
    return vbits + 12.0 * ngroups


def _tu_rd_better(bb, lv, r, lv2, r2, lam):
    """True for TUs where (lv2, r2) wins D + lambda*R against (lv, r)."""
    d = bb - r
    d2 = bb - r2
    j = _fma(lam, _tu_bits_est(lv), _isum_f32(d * d, (-2, -1)))
    j2 = _fma(lam, _tu_bits_est(lv2), _isum_f32(d2 * d2, (-2, -1)))
    return (j2 < j)[..., None, None]


def _tq_blocks(b: torch.Tensor, n: int, qp: int, bit_depth: int,
               is_intra: bool):
    """Forward DCT + scalar quant of an (B, n, n) int32 batch, plus the
    dequant + inverse DCT function. Bit-exact with core.transforms /
    core.quant (HM shifts)."""
    t = _dev_table("dct", str(b.device), n)
    log2n = n.bit_length() - 1
    s1 = log2n + bit_depth - 9
    s2 = log2n + 6
    tmp = ((_imm(b, t.T) + (1 << (s1 - 1))) >> s1).to(torch.int32)
    coef = ((_imm(t, tmp) + (1 << (s2 - 1))) >> s2).to(torch.int32)

    qp = qp + 6 * (bit_depth - 8)
    qbits = 14 + qp // 6 + (15 - bit_depth - log2n)
    f = int(QUANT_SCALES[qp % 6])
    offset = (171 if is_intra else 85) << (qbits - 9)
    lv = torch.clamp_max((coef.abs() * f + offset) >> qbits, 32767)
    lv = torch.sign(coef) * lv

    dq_shift = log2n + bit_depth - 9
    scale = int(INV_QUANT_SCALES[qp % 6]) << (qp // 6)
    bd_shift = 20 - bit_depth

    def inv(levels):
        d = ((levels * scale + (1 << (dq_shift - 1))) >> dq_shift).clamp(
            -32768, 32767)
        e = ((_imm(t.T, d) + 64) >> 7).clamp(-32768, 32767)
        return ((_imm(e, t) + (1 << (bd_shift - 1))) >> bd_shift).clamp(
            -32768, 32767).to(torch.int32)

    return lv, inv


def dense_tq_size(resid: torch.Tensor, n: int, qp: int, *,
                  bit_depth: int = 8, is_intra: bool = False, lam=None):
    """Forward DCT + quant + dequant + inverse DCT for every aligned
    (n, n) block of a residual plane. Returns (levels plane int32,
    reconstructed-residual plane int32). lam: optional SSE-domain lambda
    enabling the RDOQ-lite trial (inter) and the per-TU RD zero-out."""
    h, w = resid.shape
    b = _blocks(resid.to(torch.int32), n)
    lv, inv = _tq_blocks(b, n, qp, bit_depth, is_intra)
    r = inv(lv)
    if lam is not None:
        if not is_intra:
            lv1 = torch.where(lv.abs() <= 1, 0, lv)
            r1 = inv(lv1)
            keep1 = _tu_rd_better(b, lv, r, lv1, r1, lam)
            lv = torch.where(keep1, lv1, lv)
            r = torch.where(keep1, r1, r)
        lv, r = _tu_zero_rd(b, lv, r, lam)
    return _unblocks(lv, n, h, w), _unblocks(r, n, h, w)


def _select_by_log2(maps: dict, log2_map: torch.Tensor,
                    gran: int) -> torch.Tensor:
    """Per-pixel select between same-shaped planes keyed by TU log2."""
    out = None
    for lg, plane in maps.items():
        m = _rep(log2_map == lg, gran)
        out = torch.where(m, plane, out if out is not None else 0)
    return out


def _nz_map(lv: torch.Tensor, n: int) -> torch.Tensor:
    h, w = lv.shape
    return lv.abs().reshape(h // n, n, w // n, n).sum((1, 3)) > 0


def _pool_min(m, k: int):
    h, w = m.shape
    return m.reshape(h // k, k, w // k, k).amin((1, 3))


def _pool_max(m, k: int):
    h, w = m.shape
    return m.reshape(h // k, k, w // k, k).amax((1, 3))


def _boxsum(m: torch.Tensor, k: int) -> torch.Tensor:
    """(..., H, W) -> (..., H//k, W//k) block sums. Integer planes sum in
    their own dtype (int32 like JAX); float32 2x2 sums of non-integer
    costs add in XLA:CPU's order for a reduce over the two window axes,
    row by row: ((a00 + a01) + a10) + a11."""
    if k == 1:
        return m
    if m.is_floating_point() and k == 2:
        return (((m[..., 0::2, 0::2] + m[..., 0::2, 1::2])
                 + m[..., 1::2, 0::2]) + m[..., 1::2, 1::2])
    s = m.shape
    r = m.reshape(*s[:-2], s[-2] // k, k, s[-1] // k, k)
    if m.is_floating_point():
        return r.sum((-3, -1))
    if m.dtype == torch.bool:
        return r.sum((-3, -1), dtype=torch.int32)
    return r.sum((-3, -1), dtype=m.dtype)


def _isum_box_f32(m: torch.Tensor, k: int) -> torch.Tensor:
    """Exact block sums of an integer plane, as float32."""
    s = m.shape
    return (m.to(torch.int64)
            .reshape(*s[:-2], s[-2] // k, k, s[-1] // k, k)
            .sum((-3, -1)).to(torch.float32))


def _plane_vbits_groups(lv, n: int):
    """Per-(n, n)-TU value bits (3 + 2*bit_length per nonzero level) and
    nonzero-4x4-group count of a levels plane, as float32."""
    a = lv.abs()
    blen = _bit_length(a, 15)
    vb = torch.where(a > 0, 3 + 2 * blen, 0)
    g4 = (_boxsum(a, 4) > 0).to(torch.int32)
    return _isum_box_f32(vb, n), _isum_box_f32(g4, n // 4)


def _plane_tu_bits(lv, n: int):
    """Per-(n, n)-TU coefficient-rate proxy over a levels plane."""
    vbits, groups = _plane_vbits_groups(lv, n)
    return vbits + 7.0 * groups + 12.0


def _tu_tree_dp(res_y, rr_s, lv_s, cu_log2_8, inter8, tu_cap8, lam):
    """Residual quadtree decision: per-8-block TU size in
    [max(cu-2, 3) .. min(cu, 5)] minimizing D + lambda*bits."""
    INF = 3e38
    lo8 = torch.clamp_min(cu_log2_8 - 2, 3)
    cost = {}
    for lg in (3, 4, 5):
        n = 1 << lg
        k = n // 8
        dd = res_y.to(torch.int64) - rr_s[lg].to(torch.int64)
        d1 = _isum_box_f32(dd * dd, n)
        rd = _fma(lam, _plane_tu_bits(lv_s[lg], n) + 2.0, d1)
        valid = (_pool_min(tu_cap8, k) >= lg) & (_pool_max(lo8, k) <= lg)
        cost[lg] = torch.where(valid, rd, INF)

    best = cost[3]
    split = {}
    for lg in (4, 5):
        agg = _boxsum(best, 2) + _f32(lam * 1.0)
        split[lg] = agg < cost[lg]
        best = torch.where(split[lg], agg, cost[lg])

    nby, nbx = tu_cap8.shape
    tu8 = torch.full((nby, nbx), 3, dtype=torch.int32, device=res_y.device)
    undecided = torch.ones((nby, nbx), dtype=torch.bool, device=res_y.device)
    for lg in (5, 4):
        leaf = undecided & ~_rep(split[lg], 1 << (lg - 3))
        tu8 = torch.where(leaf, lg, tu8)
        undecided = undecided & ~leaf
    return torch.where(inter8, tu8, tu_cap8).to(torch.int32)


def encode_pass_p_direct(src_y, src_cb, src_cr, ref_y, ref_cb, ref_cr,
                         mv8, inter8, tu_log2_8, qp: int, qp_c: int,
                         bit_depth: int = 8, lam=None,
                         tu_split: bool = False, cu_log2_8=None):
    """The normative inter encode pass for one P picture with MC straight
    from the reference planes (per-block windows + spec filters, K2)."""
    pred_y = _mc_luma(_ext_y(ref_y), mv8, bit_depth, True)
    pred_cb, pred_cr = _mc_chroma(_ext_c(torch.stack([ref_cb, ref_cr])),
                                  mv8, bit_depth, True)
    return _encode_pass_core(src_y, src_cb, src_cr, pred_y, pred_cb,
                             pred_cr, inter8, tu_log2_8, qp, qp_c,
                             bit_depth, lam, tu_split, cu_log2_8)


def _encode_pass_core(src_y, src_cb, src_cr, pred_y, pred_cb, pred_cr,
                      inter8, tu_log2_8, qp: int, qp_c: int, bit_depth: int,
                      lam, tu_split: bool, cu_log2_8):
    """Residual -> dense T/Q/IQ/IT at every TU size -> RQT DP ->
    reconstruction. Planes come back as int32 (lv/rec/tu8) and bool (nz)."""
    maxval = (1 << bit_depth) - 1
    m8 = inter8.to(torch.int32)
    mask_y = _rep(m8, 8)
    mask_c = _rep(m8, 4)
    res_y = (src_y - pred_y) * mask_y
    res_cb = (src_cb - pred_cb) * mask_c
    res_cr = (src_cr - pred_cr) * mask_c

    lv_y_s, rr_y_s = {}, {}
    for lg in (3, 4, 5):
        lv_y_s[lg], rr_y_s[lg] = dense_tq_size(
            res_y, 1 << lg, qp, bit_depth=bit_depth, lam=lam)
    if tu_split and lam is not None and cu_log2_8 is not None:
        tu_log2_8 = _tu_tree_dp(res_y, rr_y_s, lv_y_s, cu_log2_8, inter8,
                                tu_log2_8, lam)
    lv_y = _select_by_log2(lv_y_s, tu_log2_8, 8)
    rr_y = _select_by_log2(rr_y_s, tu_log2_8, 8)

    ctu_log2_8 = (tu_log2_8 - 1).clamp(2, 4)
    lv_cb_s, rr_cb_s, lv_cr_s, rr_cr_s = {}, {}, {}, {}
    for lg in (2, 3, 4):
        lv_cb_s[lg], rr_cb_s[lg] = dense_tq_size(
            res_cb, 1 << lg, qp_c, bit_depth=bit_depth, lam=lam)
        lv_cr_s[lg], rr_cr_s[lg] = dense_tq_size(
            res_cr, 1 << lg, qp_c, bit_depth=bit_depth, lam=lam)
    lv_cb = _select_by_log2(lv_cb_s, ctu_log2_8, 4)
    rr_cb = _select_by_log2(rr_cb_s, ctu_log2_8, 4)
    lv_cr = _select_by_log2(lv_cr_s, ctu_log2_8, 4)
    rr_cr = _select_by_log2(rr_cr_s, ctu_log2_8, 4)

    rec_y = (pred_y + rr_y).clamp(0, maxval)
    rec_cb = (pred_cb + rr_cb).clamp(0, maxval)
    rec_cr = (pred_cr + rr_cr).clamp(0, maxval)
    return {
        "lv_y": lv_y.to(torch.int32), "lv_cb": lv_cb.to(torch.int32),
        "lv_cr": lv_cr.to(torch.int32),
        "rec_y": rec_y.to(torch.int32), "rec_cb": rec_cb.to(torch.int32),
        "rec_cr": rec_cr.to(torch.int32),
        "nz4_y": _nz_map(lv_y, 4), "nz4_cb": _nz_map(lv_cb, 4),
        "nz4_cr": _nz_map(lv_cr, 4),
        "tu8": tu_log2_8.to(torch.int32),
    }


def _round_uni(raw, bit_depth: int):
    """Uni-prediction sample (8.5.3.3.4.2) of a 14-bit K2 intermediate:
    the rounded, clipped form K2 computes when asked for rounded pixels."""
    s_u = 14 - bit_depth
    return ((raw + (1 << (s_u - 1))) >> s_u).clamp(0, (1 << bit_depth) - 1)


def _bi_select(a, b, use0, use1, k: int, bit_depth: int):
    """Per-block uni/bi combine of two 14-bit MC planes: uni rounds one
    intermediate (8.5.4.2.3.1), bi averages both (8.5.4.2.3.2). use0/use1:
    (nby, nbx) bool at 8x8-luma granularity; k: pixels per map cell in
    this plane (8 luma, 4 chroma 4:2:0)."""
    s_b = 15 - bit_depth
    bi = ((a + b + (1 << (s_b - 1))) >> s_b).clamp(0, (1 << bit_depth) - 1)
    m0, m1 = _rep(use0, k), _rep(use1, k)
    return torch.where(m0 & m1, bi, torch.where(m1, _round_uni(b, bit_depth),
                                                _round_uni(a, bit_depth)))


def mc_pred_b_direct(ref0_3, ref1_3, mv8_2l, use0, use1,
                     bit_depth: int = 8):
    """B-picture MC prediction of all three planes by direct per-block
    filtering: four K2 launches, luma and Cb + Cr per list, each in the
    14-bit domain, then the per-block uni/bi selection. ref0_3/ref1_3:
    (y, cb, cr) integer reference planes per list."""
    preds = []
    for ref3, mv in ((ref0_3, mv8_2l[0]), (ref1_3, mv8_2l[1])):
        y = _mc_luma(_ext_y(ref3[0]), mv, bit_depth, False)
        c = _mc_chroma(_ext_c(torch.stack([ref3[1], ref3[2]])), mv,
                       bit_depth, False)
        preds.append((y, c[0], c[1]))
    (a_y, a_cb, a_cr), (b_y, b_cb, b_cr) = preds
    return (_bi_select(a_y, b_y, use0, use1, 8, bit_depth),
            _bi_select(a_cb, b_cb, use0, use1, 4, bit_depth),
            _bi_select(a_cr, b_cr, use0, use1, 4, bit_depth))


def encode_pass_b_direct(src_y, src_cb, src_cr, ref0_3, ref1_3, mv8_2l,
                         ref8_2l, tu_log2_8, qp: int, qp_c: int,
                         bit_depth: int = 8, lam=None,
                         tu_split: bool = False, cu_log2_8=None):
    """The normative inter encode pass for one B picture (per-block uni /
    bi MC straight from both lists' reference planes)."""
    use0 = ref8_2l[0] >= 0
    use1 = ref8_2l[1] >= 0
    pred_y, pred_cb, pred_cr = mc_pred_b_direct(ref0_3, ref1_3, mv8_2l,
                                                use0, use1, bit_depth)
    return _encode_pass_core(src_y, src_cb, src_cr, pred_y, pred_cb,
                             pred_cr, use0 | use1, tu_log2_8, qp, qp_c,
                             bit_depth, lam, tu_split, cu_log2_8)


def mc_pred_b(raws0, raws1, mv8_2l, use0, use1, bit_depth: int = 8):
    """B-picture MC prediction of all three planes from phase planes:
    per-8x8-block uni-L0 / uni-L1 / bi selection. raws0/raws1: (raw_y,
    raw_cb, raw_cr) phase planes of each list's reference; mv8_2l: (2,
    nby, nbx, 2)."""
    a_y = _mc_gather_raw_luma(raws0[0], mv8_2l[0])
    b_y = _mc_gather_raw_luma(raws1[0], mv8_2l[1])
    a_cb = _mc_gather_raw_chroma(raws0[1], mv8_2l[0])
    b_cb = _mc_gather_raw_chroma(raws1[1], mv8_2l[1])
    a_cr = _mc_gather_raw_chroma(raws0[2], mv8_2l[0])
    b_cr = _mc_gather_raw_chroma(raws1[2], mv8_2l[1])
    return (_bi_select(a_y, b_y, use0, use1, 8, bit_depth),
            _bi_select(a_cb, b_cb, use0, use1, 4, bit_depth),
            _bi_select(a_cr, b_cr, use0, use1, 4, bit_depth))


def encode_pass_p(src_y, src_cb, src_cr, raw_y, raw_cb, raw_cr, mv8,
                  inter8, tu_log2_8, qp, qp_c, bit_depth: int = 8,
                  lam=None, tu_split: bool = False, cu_log2_8=None):
    """The normative inter encode pass for one P picture with MC gathered
    from the L0 reference's phase planes (raw_*). mv8: (nby, nbx, 2)
    quarter-pel MV per 8x8 block; inter8: bool map (intra blocks get zero
    residual); tu_log2_8: luma TU log2 per 8x8 block. qp / qp_c: ints or
    0-d integer tensors. Returns _encode_pass_core's dict."""
    pred_y = mc_pred_luma(raw_y, mv8, bit_depth)
    pred_cb = mc_pred_chroma(raw_cb, mv8, bit_depth)
    pred_cr = mc_pred_chroma(raw_cr, mv8, bit_depth)
    return _encode_pass_core(src_y, src_cb, src_cr, pred_y, pred_cb,
                             pred_cr, inter8, tu_log2_8, int(qp), int(qp_c),
                             bit_depth, lam, tu_split, cu_log2_8)


def encode_pass_b(src_y, src_cb, src_cr, raws0, raws1, mv8_2l, ref8_2l,
                  tu_log2_8, qp, qp_c, bit_depth: int = 8, lam=None,
                  tu_split: bool = False, cu_log2_8=None):
    """The inter encode pass for one B picture with MC gathered from both
    lists' phase planes: per-8x8-block uni-L0 / uni-L1 / bi prediction,
    then the shared residual core. ref8_2l: (2, nby, nbx) per-list ref idx
    (-1 unused). qp / qp_c: ints or 0-d integer tensors."""
    use0 = ref8_2l[0] >= 0
    use1 = ref8_2l[1] >= 0
    pred_y, pred_cb, pred_cr = mc_pred_b(raws0, raws1, mv8_2l, use0, use1,
                                         bit_depth)
    return _encode_pass_core(src_y, src_cb, src_cr, pred_y, pred_cb,
                             pred_cr, use0 | use1, tu_log2_8, int(qp),
                             int(qp_c), bit_depth, lam, tu_split, cu_log2_8)


# ---------------------------------------------------------------- dense MD

def _recenter8(ref_ext: torch.Tensor, cy8: torch.Tensor, cx8: torch.Tensor,
               h: int, w: int) -> torch.Tensor:
    """Recentred integer reference: each 8x8 block displaced by its own
    full-pel center (cy8, cx8). ref_ext padded by PAD."""
    dev = ref_ext.device
    sy = (torch.arange(h // 8, device=dev) * 8)[:, None] + cy8 + PAD
    sx = (torch.arange(w // 8, device=dev) * 8)[None, :] + cx8 + PAD
    return _gather_blocks(ref_ext[None], torch.zeros_like(sy), sy, sx, 8,
                          h, w)


def _sad_stack8(src: torch.Tensor, rec: torch.Tensor, r: int):
    """SAD of every 8x8 block vs the recentred ref displaced by every
    (dy, dx) in [-r, r]^2: (2r+1, 2r+1, nby, nbx) int32."""
    h, w = src.shape
    pad = _edge_pad(rec, r)
    rows = []
    for dy in range(2 * r + 1):
        row = []
        for dx in range(2 * r + 1):
            sh = pad[dy:dy + h, dx:dx + w]
            row.append(_boxsum((src - sh).abs(), 8))
        rows.append(torch.stack(row))
    return torch.stack(rows)


def _mvd_bits_dev(v: torch.Tensor) -> torch.Tensor:
    """Approximate MVD rate: 1 bit for 0, 3 for +/-1, else
    4 + 2*bit_length(|v|-2 clamped to >=1)."""
    a = v.abs()
    big = torch.clamp_min(a - 2, 1)
    out = 4 + 2 * _bit_length(big, 12)
    out = torch.where(a == 1, 3, out)
    return torch.where(a == 0, 1, out).to(torch.int32)


def _int_field(int_mvx, int_mvy, k: int) -> torch.Tensor:
    """Per-k-block integer MVs as a quarter-pel 8x8-grid field."""
    return torch.stack([_rep(int_mvx, k // 8) * 4,
                        _rep(int_mvy, k // 8) * 4], -1)


def _subpel_raw8(raw16: torch.Tensor, mvqx: torch.Tensor,
                 mvqy: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """14-bit MC gather where every 8x8 block uses its own quarter-pel MV
    from a (16, Hp, Wp) flat phase stack (the bi-prediction intermediate
    form of _subpel_pred8)."""
    dev = raw16.device
    ph = (mvqy & 3) * 4 + (mvqx & 3)
    sy = (torch.arange(h // 8, device=dev) * 8)[:, None] + (mvqy >> 2) + PAD
    sx = (torch.arange(w // 8, device=dev) * 8)[None, :] + (mvqx >> 2) + PAD
    return _gather_blocks(raw16, ph, sy, sx, 8, h, w)


def _subpel_pred8(raw16: torch.Tensor, mvq8x: torch.Tensor,
                  mvq8y: torch.Tensor, h: int, w: int,
                  bit_depth: int) -> torch.Tensor:
    """Rounded prediction plane where every 8x8 block uses its own
    quarter-pel MV (raw16: (16, Hp, Wp) flat phase stack)."""
    return _round_uni(_subpel_raw8(raw16, mvq8x, mvq8y, h, w), bit_depth)


_HALF_OFFS = ((-2, -2), (-2, 0), (-2, 2), (0, -2), (0, 2), (2, -2), (2, 0),
              (2, 2))
_QUARTER_OFFS = ((-1, -1), (-1, 0), (-1, 1), (0, -1), (0, 1), (1, -1),
                 (1, 0), (1, 1))


def _refine_subpel(src, raw16, mvqx, mvqy, best, k: int, bit_depth: int):
    """One half-pel then one quarter-pel 8-neighbour stage around the
    per-k-block best (mvqx, mvqy), each stage's candidates around the
    previous stage's winner; SADs summed at k granularity, strict-<
    updates in the offset tables' order (ties keep the earlier winner).
    Returns the updated (mvqx, mvqy, best)."""
    h, w = src.shape
    for offs in (_HALF_OFFS, _QUARTER_OFFS):
        cx, cy = mvqx, mvqy
        for oy, ox in offs:
            tx, ty = cx + ox, cy + oy
            pred = _subpel_pred8(raw16, _rep(tx, k // 8), _rep(ty, k // 8),
                                 h, w, bit_depth)
            sad = _boxsum((src - pred).abs(), k)
            take = sad < best
            mvqx = torch.where(take, tx, mvqx)
            mvqy = torch.where(take, ty, mvqy)
            best = torch.where(take, sad, best)
    return mvqx, mvqy, best


def _refine_subpel_dense(src, rec, int_mvx, int_mvy, best, k: int,
                         bit_depth: int, lam_me=None, cqx=None, cqy=None):
    """Exhaustive +/-3 quarter-pel refinement around the per-k-block best
    integer MV. `rec` is the reference recentred at the integer MVs (K2 on
    _int_field(int_mvx, int_mvy, k)); the 16 subpel phases of it are
    interpolated, then every candidate is a static slice of a phase plane.
    Candidates run in the reference's order with strict-< updates, so ties
    keep the earlier winner."""
    h, w = src.shape
    maxval = (1 << bit_depth) - 1
    raw = luma_phase_planes(rec, bit_depth=bit_depth)
    raw16 = raw.reshape(16, raw.shape[2], raw.shape[3])
    shift = 14 - bit_depth
    mvqx, mvqy = int_mvx * 4, int_mvy * 4
    for fy in range(-3, 4):
        for fx in range(-3, 4):
            if fy == 0 and fx == 0:
                continue
            pl = (fy & 3) * 4 + (fx & 3)
            cy = (fy >> 2) + PAD
            cx = (fx >> 2) + PAD
            plane = raw16[pl, cy:cy + h, cx:cx + w]
            pred = ((plane + (1 << (shift - 1))) >> shift).clamp(0, maxval)
            sad = _boxsum((src - pred).abs(), k)
            if lam_me is not None:
                sad = sad + lam_me * (
                    _mvd_bits_dev(int_mvx * 4 + fx - cqx)
                    + _mvd_bits_dev(int_mvy * 4 + fy - cqy))
            take = sad < best
            mvqx = torch.where(take, int_mvx * 4 + fx, mvqx)
            mvqy = torch.where(take, int_mvy * 4 + fy, mvqy)
            best = torch.where(take, sad, best)
    return mvqx, mvqy, best


def dense_md_p(src: torch.Tensor, ref: torch.Tensor, hme_mv: torch.Tensor,
               bit_depth: int = 8, qp: int | None = None,
               subpel_min: int = 16) -> dict:
    """Dense inter search for every CU size of a P picture (integer SAD
    stacks at 8x8 granularity around shared per-16 and per-64 HME centers,
    bottom-up sums, argmin per size, then dense subpel refinement)."""
    h, w = src.shape
    dev = src.device
    srcf = src.to(torch.int32)
    ref_ext = _ext_y(ref)
    lim = (PAD - 9) * 4
    lam_me = (0 if qp is None
              else ME_LAMBDA_SCALE * int(LAMBDA_SAD[qp]))

    c16x = (hme_mv[..., 0] >> 2).clamp(-(PAD - 12), PAD - 12)
    c16y = (hme_mv[..., 1] >> 2).clamp(-(PAD - 12), PAD - 12)
    nb64y, nb64x = h // 64, w // 64
    c64x = c16x.to(torch.float32).reshape(nb64y, 4, nb64x, 4).mean(
        (1, 3)).to(torch.int32)
    c64y = c16y.to(torch.float32).reshape(nb64y, 4, nb64x, 4).mean(
        (1, 3)).to(torch.int32)

    # the reference recentred at the per-16 and the per-64 centers: one
    # K2 launch
    rec_f, rec_c = _mc_luma(ref_ext, torch.stack(
        [_int_field(c16x, c16y, 16), _int_field(c64x, c64y, 64)]),
        bit_depth, True)
    stack8 = _sad_stack8(srcf, rec_f, 2)
    nb8y, nb8x = h // 8, w // 8
    stack16 = _boxsum(stack8.reshape(25, nb8y, nb8x), 2).reshape(
        5, 5, nb8y // 2, nb8x // 2)

    def best_of(stack, cyk, cxk, r):
        d = torch.arange(-r, r + 1, device=dev)
        rate = (_mvd_bits_dev(4 * d)[:, None]
                + _mvd_bits_dev(4 * d)[None, :]).reshape(-1, 1, 1)
        s = (stack.reshape((2 * r + 1) ** 2, *stack.shape[2:])
             + lam_me * rate)
        k = torch.argmin(s, dim=0).to(torch.int32)
        sad = s.amin(dim=0)
        mvy = (k // (2 * r + 1) - r + cyk) * 4
        mvx = (k % (2 * r + 1) - r + cxk) * 4
        return mvx.clamp(-lim, lim), mvy.clamp(-lim, lim), sad

    mv8x, mv8y, sad8 = best_of(stack8, _rep(c16y, 2), _rep(c16x, 2), 2)
    mv16x, mv16y, sad16 = best_of(stack16, c16y, c16x, 2)

    stack8c = _sad_stack8(srcf, rec_c, 3)
    stack32 = _boxsum(stack8c.reshape(49, nb8y, nb8x), 4).reshape(
        7, 7, nb8y // 4, nb8x // 4)
    stack64 = _boxsum(stack8c.reshape(49, nb8y, nb8x), 8).reshape(
        7, 7, nb64y, nb64x)

    mv32x, mv32y, sad32 = best_of(stack32, _rep(c64y, 2), _rep(c64x, 2), 3)
    mv64x, mv64y, sad64 = best_of(stack64, c64y, c64x, 3)

    # subpel refinement per size; the three recentrings are independent
    # (each on its own size's integer winners): one K2 launch
    lam_sub = None if qp is None else lam_me
    sub = {16: (mv16x, mv16y, sad16, c16x * 4, c16y * 4),
           32: (mv32x, mv32y, sad32, _rep(c64x, 2) * 4, _rep(c64y, 2) * 4),
           64: (mv64x, mv64y, sad64, c64x * 4, c64y * 4)}
    sizes = [k for k in (16, 32, 64) if k == 64 or subpel_min <= k]
    recs = _mc_luma(ref_ext, torch.stack(
        [_int_field(sub[k][0] >> 2, sub[k][1] >> 2, k) for k in sizes]),
        bit_depth, True)
    for k, rec in zip(sizes, recs):
        mvx, mvy, sad, cqx, cqy = sub[k]
        sub[k] = _refine_subpel_dense(
            srcf, rec, mvx >> 2, mvy >> 2, sad, k, bit_depth,
            lam_me=lam_sub, cqx=cqx, cqy=cqy)
    mv16x, mv16y, sad16 = sub[16][:3]
    mv32x, mv32y, sad32 = sub[32][:3]
    mv64x, mv64y, sad64 = sub[64][:3]

    p4 = PAD + 4
    zdiff = (srcf - ref_ext[p4:p4 + h, p4:p4 + w]).abs()
    z8 = _boxsum(zdiff, 8)
    return {
        "mv8": torch.stack([mv8x, mv8y], -1).to(torch.int16),
        "sad8": torch.clamp_max(sad8, 1 << 30).to(torch.int32),
        "mv16": torch.stack([mv16x, mv16y], -1).to(torch.int16),
        "sad16": sad16.to(torch.int32),
        "mv32": torch.stack([mv32x, mv32y], -1).to(torch.int16),
        "sad32": sad32.to(torch.int32),
        "mv64": torch.stack([mv64x, mv64y], -1).to(torch.int16),
        "sad64": sad64.to(torch.int32),
        "zsad8": z8.to(torch.int32),
    }


# ------------------------------------------------------------ packed transfer

def _pack(arrs, dtype) -> torch.Tensor:
    return torch.cat([a.reshape(-1).to(dtype) for a in arrs])


def unpack(flat: np.ndarray, specs):
    """Split a fetched flat buffer back into named arrays."""
    out = {}
    off = 0
    for name, shape, dt in specs:
        n = int(np.prod(shape))
        out[name] = np.ascontiguousarray(
            flat[off:off + n]).astype(dt).reshape(shape)
        off += n
    return out


def prep_planes(y, cb, cr, w64: int, h64: int, device):
    """Upload-side prep: ship the planes (uint8 as they are, a quarter of
    the int32 bytes; 10-bit uint16 planes converted to int32 on the host,
    since torch's uint16 has few CUDA kernels), then edge-pad them to the
    64-aligned coded grid as int32 device tensors."""
    def up(p, ww, hh):
        p = np.ascontiguousarray(p)
        if p.dtype != np.uint8:
            p = p.astype(np.int32)
        t = torch.from_numpy(p).to(device).to(torch.int32)
        ph, pw = t.shape
        return edge_pad(t, 0, hh - ph, 0, ww - pw)
    return (up(y, w64, h64), up(cb, w64 // 2, h64 // 2),
            up(cr, w64 // 2, h64 // 2))


# The packed one-download forms of the separate stages (the JAX package's
# stage-by-stage P pipeline, which tools and the mesh step call): each
# returns ONE flat tensor that unpack(..., specs) splits on the host.

MD_KEYS = ("mv8", "sad8", "mv16", "sad16", "mv32", "sad32",
           "mv64", "sad64", "zsad8")
EP_KEYS = ("lv_y", "lv_cb", "lv_cr", "rec_y", "rec_cb", "rec_cr",
           "nz4_y", "nz4_cb", "nz4_cr")


def dense_md_p_packed(src, ref, hme_mv, bit_depth: int = 8) -> torch.Tensor:
    """dense_md_p (no MV rate, the default sub-pel sizes) packed as int32
    in MD_KEYS order (md_specs). The JAX form's unused raw_y argument is
    left out, as in dense_md_p."""
    out = dense_md_p(src, ref, hme_mv, bit_depth=bit_depth)
    return _pack([out[k] for k in MD_KEYS], torch.int32)


def md_specs(h64: int, w64: int):
    sp = []
    for n in (8, 16, 32, 64):
        g = (h64 // n, w64 // n)
        sp.append((f"mv{n}", (*g, 2), np.int32))
        sp.append((f"sad{n}", g, np.int32))
    sp.append(("zsad8", (h64 // 8, w64 // 8), np.int32))
    return sp


def encode_pass_p_packed(src_y, src_cb, src_cr, raw_y, raw_cb, raw_cr,
                         mv8, inter8, tu_log2_8, qp, qp_c,
                         bit_depth: int = 8) -> torch.Tensor:
    """encode_pass_p packed as int16 in EP_KEYS order (ep_specs)."""
    out = encode_pass_p(src_y, src_cb, src_cr, raw_y, raw_cb, raw_cr, mv8,
                        inter8, tu_log2_8, qp, qp_c, bit_depth=bit_depth)
    return _pack([out[k] for k in EP_KEYS], torch.int16)


def ep_specs(h64: int, w64: int):
    hc, wc = h64 // 2, w64 // 2
    return [("lv_y", (h64, w64), np.int32),
            ("lv_cb", (hc, wc), np.int32),
            ("lv_cr", (hc, wc), np.int32),
            ("rec_y", (h64, w64), np.int32),
            ("rec_cb", (hc, wc), np.int32),
            ("rec_cr", (hc, wc), np.int32),
            ("nz4_y", (h64 // 4, w64 // 4), bool),
            ("nz4_cb", (h64 // 8, w64 // 8), bool),
            ("nz4_cr", (h64 // 8, w64 // 8), bool)]


def sao_stats_frame_packed(pre_y, pre_cb, pre_cr, src_y, src_cb, src_cr,
                           ctb: int, h: int, w: int,
                           bit_depth: int = 8) -> torch.Tensor:
    """SAO statistics of all three planes packed into one int32 tensor
    (sao_specs). pre_* / src_*: planes at 64-aligned coded dims; the
    valid area comes from (h, w)."""
    flats = []
    for comp, (pre, src) in enumerate(((pre_y, src_y), (pre_cb, src_cb),
                                       (pre_cr, src_cr))):
        hp, wp = pre.shape
        c = ctb if comp == 0 else ctb // 2
        hv = h if comp == 0 else h // 2
        wv = w if comp == 0 else w // 2
        valid = ((torch.arange(hp, device=pre.device)[:, None] < hv)
                 & (torch.arange(wp, device=pre.device)[None, :] < wv))
        out = sao_stats_plane(pre.to(torch.int32), src.to(torch.int32),
                              valid.to(torch.float32), c, c,
                              bit_depth=bit_depth)
        flats.extend(out[k] for k in ("eo_cnt", "eo_sum", "bo_cnt",
                                      "bo_sum"))
    return _pack(flats, torch.int32)


def sao_specs(ctb: int, h64: int, w64: int):
    sp = []
    for comp in range(3):
        ny = h64 // ctb if comp == 0 else (h64 // 2) // (ctb // 2)
        nx = w64 // ctb if comp == 0 else (w64 // 2) // (ctb // 2)
        sp.append((f"eo_cnt{comp}", (ny, nx, 4, 5), np.int64))
        sp.append((f"eo_sum{comp}", (ny, nx, 4, 5), np.int64))
        sp.append((f"bo_cnt{comp}", (ny, nx, 32), np.int64))
        sp.append((f"bo_sum{comp}", (ny, nx, 32), np.int64))
    return sp


# --------------------------------------------------- fused device fast path

def _satd8_map(diff: torch.Tensor) -> torch.Tensor:
    """Per-8x8-block integer Hadamard SATD of a residual plane."""
    h, w = diff.shape
    b = _blocks(diff.to(torch.int32), 8)
    h8 = _dev_table("had8", str(diff.device))
    t = _imm(_imm(h8, b), h8.T)
    s = t.abs().sum((-2, -1)) // 4
    return s.to(torch.int32).reshape(h // 8, w // 8)


def _plane_tu_bits_rd(lv, n: int):
    """Per-TU coefficient-rate estimate; an all-zero TU costs 1 bit."""
    vbits, groups = _plane_vbits_groups(lv, n)
    return torch.where(vbits > 0, vbits + 7.0 * groups + 12.0, 1.0)


def _rd_leaf_cost(srcf, pred, s: int, qp: int, lam_sse: float, sig_bits,
                  bit_depth: int, is_intra: bool = False):
    """True-RD cost of coding every (s, s) CU with prediction `pred`:
    T/Q at TU min(s, 32), post-quant SSE + lambda * (coefficient bits +
    signalling bits). sig_bits: per-CU tensor, or a constant."""
    tun = min(s, 32)
    resid = srcf - pred
    lv, rr = dense_tq_size(resid, tun, qp, bit_depth=bit_depth,
                           is_intra=is_intra, lam=lam_sse)
    dd = resid - rr
    d = _isum_box_f32(dd * dd, s)
    rbits = _boxsum(_plane_tu_bits_rd(lv, tun), s // tun)
    if isinstance(sig_bits, torch.Tensor):
        sig_bits = sig_bits.to(torch.float32)
    return _fma(lam_sse, rbits + sig_bits, d)


def _scale_mv_dev(mv, tb: int, td: int):
    """core.inter._scale_mv_td (8.5.3.2.8) on a device MV field: POC
    distances are host ints, truncation toward zero, identical clamps."""
    tb = min(max(int(tb), -128), 127)
    td = min(max(int(td), -128), 127)
    if td == tb or td == 0:
        return mv
    n = 16384 + (abs(td) >> 1)
    tx = (1 if td > 0 else -1) * (n // abs(td))
    dsf = min(max((tb * tx + 32) >> 6, -4096), 4095)
    v = dsf * mv
    mag = (v.abs() + 127) >> 8
    return torch.where(v >= 0, mag, -mag).clamp(-32768, 32767)


def _tmvp_candidate(col16_mv, col16_valid, s: int, gshape, ctb_log2: int,
                    w: int, h: int):
    """Per-s-block TMVP merge candidate from the collocated picture's
    16x16-compressed motion (bottom-right if inside the picture and the
    same CTB row, else center)."""
    gy, gx = gshape
    dev = col16_mv.device
    y0 = torch.arange(gy, device=dev) * s
    x0 = torch.arange(gx, device=dev) * s
    mh, mw = col16_valid.shape
    br_row_ok = (y0 + s < h) & ((y0 + s) >> ctb_log2 == y0 >> ctb_log2)
    br_ok = br_row_ok[:, None] & (x0 + s < w)[None, :]
    ybr = ((y0 + s) >> 4).clamp(0, mh - 1)
    xbr = ((x0 + s) >> 4).clamp(0, mw - 1)
    yc = ((y0 + s // 2) >> 4).clamp(0, mh - 1)
    xc = ((x0 + s // 2) >> 4).clamp(0, mw - 1)
    v_br = col16_valid[ybr[:, None], xbr[None, :]] & br_ok
    mv_br = col16_mv[ybr[:, None], xbr[None, :]]
    v_c = col16_valid[yc[:, None], xc[None, :]]
    mv_c = col16_mv[yc[:, None], xc[None, :]]
    mv = torch.where(v_br[..., None], mv_br, mv_c)
    return mv, v_br | v_c


def decide_tree_dev(md: dict, ois: dict, ctb_log2: int, *,
                    min_intra_log2: int = 3, w: int | None = None,
                    h: int | None = None, qp: int | None = None, src=None,
                    ref=None, bit_depth: int = 8, col_mv8=None,
                    col_valid8=None, tb: int = 1, td: int = 1):
    """Bottom-up quadtree DP over the dense cost maps of a P picture.

    With src/ref/qp (the fused paths' form): per CU size, SATD of the
    candidates (ME winner, left/top neighbours, zero, TMVP), a true-RD
    stage between the SATD winner and the merge-class runner-up, J-domain
    leaf costs, then the split DP. Without src (the SAD form that
    fast_p_fused_packed runs, and the device mirror of
    pipeline.fast_path.decide_tree): the ME winner's SAD against the
    zero MV's, integer costs at the constant lambda 3. Where w/h are
    given, CUs crossing the coded boundary always split. Returns
    (cu_log2_8, inter8, mv8, mode8)."""
    if src is None:
        return _decide_tree_sad_dev(md, ois, ctb_log2, min_intra_log2, w, h)
    INF = 1 << 30
    lim_q = (PAD - 9) * 4
    lam = 2 * int(LAMBDA_SAD[qp])                 # SATD ~ 2x SAD scale
    lam_sse = float(_LAM_SSE_P[qp])
    j_ratio = _f32(np.float32(lam_sse) / np.float32(max(lam, 1.0)))
    srcf = src.to(torch.int32)
    ref_ext4 = _ext_y(ref)
    zs = {8: _satd8_map(srcf - ref.to(torch.int32))}
    col16_mv = col16_v = None
    if col_mv8 is not None:
        col16_v = col_valid8
        col16_mv = _scale_mv_dev(col_mv8.to(torch.int32), tb, td)
    for s in (16, 32, 64):
        zs[s] = _boxsum(zs[s // 2], 2)

    leaf_cost, leaf_inter, leaf_mv, leaf_mode = {}, {}, {}, {}
    sizes = [s for s in (8, 16, 32, 64) if (1 << ctb_log2) >= s]
    for s in sizes:
        mv = md[f"mv{s}"].to(torch.int32)
        rep = s // 8
        mvL = torch.cat([mv[:, :1], mv[:, :-1]], 1)
        mvT = torch.cat([mv[:1], mv[:-1]], 0)

        def preds_of(*mvs, rep=rep):
            """K2 predictions of per-s-block MV fields, one launch."""
            mvf = torch.stack(mvs).repeat_interleave(rep, 1)
            return _mc_luma(ref_ext4, mvf.repeat_interleave(rep, 2),
                            bit_depth, True)

        def satd_of(pred, rep=rep):
            return _boxsum(_satd8_map(srcf - pred), rep)

        # ME, left, top (and TMVP) candidates: one launch
        cand_mvs = [mv, mvL, mvT]
        if col16_mv is not None:
            mv_t, v_t = _tmvp_candidate(col16_mv, col16_v, s, mv.shape[:2],
                                        ctb_log2, w, h)
            mv_t = mv_t.clamp(-lim_q, lim_q)
            cand_mvs.append(mv_t)
        preds = preds_of(*cand_mvs)
        d_me = satd_of(preds[0])
        d_l = satd_of(preds[1])
        d_t = satd_of(preds[2])
        bits_me = (_mvd_bits_dev(mv[..., 0] - mvL[..., 0])
                   + _mvd_bits_dev(mv[..., 1] - mvL[..., 1])
                   + AMVP_BASE_BITS)
        zerL = (mvL == 0).all(-1)
        zerT = (mvT == 0).all(-1)
        bits_z = torch.where(zerL | zerT, 3, 10).to(torch.int32)
        cands_d = [d_me, d_l, d_t, zs[s]]
        cands_bits = [bits_me, torch.full_like(bits_me, 2),
                      torch.full_like(bits_me, 3), bits_z]
        cands_mv = [mv, mvL, mvT, torch.zeros_like(mv)]
        if col16_mv is not None:
            d_tm = torch.where(v_t, satd_of(preds[3]), 1 << 29)
            cands_d.append(d_tm)
            cands_bits.append(torch.full_like(bits_me, TMVP_BITS))
            cands_mv.append(mv_t)
        bits_stack = torch.stack(cands_bits)
        c_stack = (torch.stack(cands_d) + lam * bits_stack).to(torch.int32)
        mv_stack = torch.stack(cands_mv)
        k = torch.argmin(c_stack, dim=0)
        inter_c = c_stack.amin(dim=0)
        kc = torch.argmin(c_stack[1:], dim=0) + 1

        def take(stack, idx):
            return torch.gather(stack, 0, idx[None])[0]

        def take_mv(idx):
            ix = idx[None, ..., None].expand(1, *idx.shape, 2)
            return torch.gather(mv_stack, 0, ix)[0]

        # the SATD winner and the merge-class runner-up: one launch
        mv_sel = take_mv(k)
        pred_sel, pred_cheap = preds_of(mv_sel, take_mv(kc))
        j_sel = _rd_leaf_cost(srcf, pred_sel, s, qp, lam_sse,
                              take(bits_stack, k), bit_depth)
        j_cheap = _rd_leaf_cost(srcf, pred_cheap, s, qp, lam_sse,
                                take(bits_stack, kc), bit_depth)
        use_cheap = ((j_cheap < j_sel + _f32(np.float32(lam_sse)
                                              * MERGE_BIAS_BITS))
                     & (k != kc))
        inter_j = torch.where(use_cheap, torch.minimum(j_cheap, j_sel),
                              j_sel)
        mv_sel = torch.where(use_cheap[..., None], take_mv(kc), mv_sel)
        if 32 >= s >= (1 << min_intra_log2):
            mode_map, cost_map = ois[s]
            intra_c = 2 * cost_map + lam * 6
            fails = inter_c > (lam * s * s) >> 1
            intra_c = torch.where(fails, intra_c, INF)
        else:
            intra_c = torch.full_like(inter_c, INF)
            mode_map = torch.zeros_like(inter_c)
        use_intra = intra_c < inter_c
        # the intra leaf only has a SATD-stage cost: convert it to J
        leaf_cost[s] = torch.where(
            use_intra,
            torch.clamp_max(j_ratio * intra_c.to(torch.float32), 3e37),
            inter_j)
        leaf_inter[s] = ~use_intra
        leaf_mv[s] = mv_sel
        leaf_mode[s] = mode_map.to(torch.int32)

    split_charge = _f32(np.float32(lam_sse) * np.float32(3.0))
    return _tree_walk(leaf_cost, leaf_inter, leaf_mv, leaf_mode, sizes,
                      split_charge, w, h)


def _decide_tree_sad_dev(md: dict, ois: dict, ctb_log2: int,
                         min_intra_log2: int, w, h):
    """decide_tree_dev's SAD form (see there): int32 leaf costs
    sad + 3 * (mvd bits + 4) against zsad + 3 * 3, intra where
    2 * cost + 18 is lower and inter fails its threshold."""
    INF = 1 << 30
    lam = 3
    zs = {8: md["zsad8"].to(torch.int32)}
    for s in (16, 32, 64):
        zs[s] = _boxsum(zs[s // 2], 2)
    leaf_cost, leaf_inter, leaf_mv, leaf_mode = {}, {}, {}, {}
    sizes = [s for s in (8, 16, 32, 64) if (1 << ctb_log2) >= s]
    for s in sizes:
        mv = md[f"mv{s}"].to(torch.int32)
        bits = _mvd_bits_dev(mv[..., 0]) + _mvd_bits_dev(mv[..., 1])
        ic = md[f"sad{s}"].to(torch.int32) + lam * (bits + 4)
        zc = zs[s] + lam * 3
        use_zero = zc < ic
        inter_c = torch.where(use_zero, zc, ic)
        mv_sel = torch.where(use_zero[..., None], 0, mv)
        if 32 >= s >= (1 << min_intra_log2):
            mode_map, cost_map = ois[s]
            intra_c = 2 * cost_map.to(torch.int32) + lam * 6
            fails = inter_c > (lam * s * s) >> 1
            intra_c = torch.where(fails, intra_c, INF)
        else:
            intra_c = torch.full_like(inter_c, INF)
            mode_map = torch.zeros_like(inter_c)
        use_intra = intra_c < inter_c
        leaf_cost[s] = torch.where(use_intra, intra_c, inter_c)
        leaf_inter[s] = ~use_intra
        leaf_mv[s] = mv_sel
        leaf_mode[s] = mode_map.to(torch.int32)
    return _tree_walk(leaf_cost, leaf_inter, leaf_mv, leaf_mode, sizes,
                      lam * 2, w, h)


def _tree_walk(leaf_cost, leaf_inter, leaf_mv, leaf_mode, sizes,
               split_charge, w, h):
    """The split DP over per-size leaf costs (a node splits where its
    children's best plus the split charge is lower, or, given w/h, where
    it crosses the coded boundary), then the walk down to per-8x8-block
    (cu_log2_8, inter8, mv8, mode8)."""
    best = {8: leaf_cost[8]}
    split = {}
    dev = leaf_cost[8].device
    for s in sizes[1:]:
        agg = _boxsum(best[s // 2], 2) + split_charge
        split[s] = agg < leaf_cost[s]
        if w is not None:
            gy, gx = leaf_cost[s].shape
            cross = (((torch.arange(gx, device=dev) * s + s) > w)[None, :]
                     | ((torch.arange(gy, device=dev) * s + s)
                        > h)[:, None])
            split[s] = split[s] | cross
        best[s] = torch.where(split[s], agg, leaf_cost[s])

    nby, nbx = leaf_cost[8].shape
    cu_log2 = torch.zeros((nby, nbx), dtype=torch.int32, device=dev)
    inter8 = torch.zeros((nby, nbx), dtype=torch.bool, device=dev)
    mv8 = torch.zeros((nby, nbx, 2), dtype=torch.int32, device=dev)
    mode8 = torch.zeros((nby, nbx), dtype=torch.int32, device=dev)
    undecided = torch.ones((nby, nbx), dtype=torch.bool, device=dev)
    for s in reversed(sizes):
        k = s // 8
        leaf_here = undecided if s == 8 else undecided & ~_rep(split[s], k)
        lg = s.bit_length() - 1
        cu_log2 = torch.where(leaf_here, lg, cu_log2)
        inter_rep = _rep(leaf_inter[s], k)
        inter8 = torch.where(leaf_here, inter_rep, inter8)
        take_here = (leaf_here & inter_rep)[..., None]
        mv8 = torch.where(take_here, _rep(leaf_mv[s], k), mv8)
        mode8 = torch.where(leaf_here, _rep(leaf_mode[s], k), mode8)
        undecided = undecided & ~leaf_here
    return cu_log2.to(torch.int32), inter8, mv8.to(torch.int32), \
        mode8.to(torch.int32)


def decide_tree_b_dev(md0: dict, md1: dict, ois: dict, ctb_log2: int,
                      src, ref0, ref1, *, min_intra_log2: int = 4, w: int,
                      h: int, qp: int, bit_depth: int = 8):
    """Bottom-up quadtree DP of a B picture. Per CU size the candidates
    are uni-L0 and uni-L1 (each list's ME winner, left / top neighbours
    and zero MV, as in decide_tree_dev), bi (both ME winners, sizes >= 16)
    and gated intra, ranked by SATD; a true-RD stage then compares the
    SATD winner with the cheapest merge-class candidate of both lists.
    Each list's fields of every size go into one K2 launch (the 14-bit
    ME predictions feed the bi average; the neighbours are rounded from
    the same launch), and the finalists of every size into a second.
    Returns (cu_log2_8, ref8_2l (2, nby, nbx), mv8_2l (2, nby, nbx, 2),
    mode8)."""
    INF = 1 << 30
    lam = 2 * int(LAMBDA_SAD[qp])                 # SATD ~ 2x SAD scale
    lam_sse = float(_LAM_SSE_P[qp])
    j_ratio = _f32(np.float32(lam_sse) / np.float32(max(lam, 1.0)))
    srcf = src.to(torch.int32)
    dev = srcf.device
    maxval = (1 << bit_depth) - 1
    s_b = 15 - bit_depth
    exts = (_ext_y(ref0), _ext_y(ref1))
    zs = []
    for ref in (ref0, ref1):
        z = {8: _satd8_map(srcf - ref.to(torch.int32))}
        for s in (16, 32, 64):
            z[s] = _boxsum(z[s // 2], 2)
        zs.append(z)
    sizes = [s for s in (8, 16, 32, 64) if (1 << ctb_log2) >= s]

    def up_mv(mv, rep):
        return mv.repeat_interleave(rep, 0).repeat_interleave(rep, 1)

    def satd_of(pred, rep):
        return _boxsum(_satd8_map(srcf - pred), rep)

    def take(stack, idx):
        return torch.gather(stack, 0, idx[None])[0]

    def take_mv(stack, idx):
        ix = idx[None, ..., None].expand(1, *idx.shape, 2)
        return torch.gather(stack, 0, ix)[0]

    # ---- stage 1, per list: ME winner, left and top candidates of every
    # size in one launch; the merge-aware per-list ranking (ME winner at
    # predictor-relative MVD cost, neighbours at merge cost, zero MV
    # merge-priced only when a neighbour is zero)
    uni = ({}, {})
    for li, md in enumerate((md0, md1)):
        fields, per_size = [], []
        for s in sizes:
            rep = s // 8
            mv = md[f"mv{s}"].to(torch.int32)
            mvL = torch.cat([mv[:, :1], mv[:, :-1]], 1)
            mvT = torch.cat([mv[:1], mv[:-1]], 0)
            fields += [up_mv(mv, rep), up_mv(mvL, rep), up_mv(mvT, rep)]
            per_size.append((s, mv, mvL, mvT))
        raws = iter(_mc_luma(exts[li], torch.stack(fields), bit_depth,
                             False))
        for s, mv, mvL, mvT in per_size:
            rep = s // 8
            raw_me = next(raws)
            d_me = satd_of(_round_uni(raw_me, bit_depth), rep)
            d_l = satd_of(_round_uni(next(raws), bit_depth), rep)
            d_t = satd_of(_round_uni(next(raws), bit_depth), rep)
            b_me = (_mvd_bits_dev(mv[..., 0] - mvL[..., 0])
                    + _mvd_bits_dev(mv[..., 1] - mvL[..., 1]))
            zerN = (mvL == 0).all(-1) | (mvT == 0).all(-1)
            bits_stack = torch.stack([
                b_me + 4 + li, torch.full_like(b_me, 2),
                torch.full_like(b_me, 3),
                torch.where(zerN, 3, 10).to(torch.int32)])
            c_stack = (torch.stack([d_me, d_l, d_t, zs[li][s]])
                       + lam * bits_stack).to(torch.int32)
            mv_stack = torch.stack([mv, mvL, mvT, torch.zeros_like(mv)])
            k = torch.argmin(c_stack, dim=0)
            kc = torch.argmin(c_stack[1:], dim=0) + 1
            uni[li][s] = {
                "raw": raw_me, "b_me": b_me, "c": c_stack.amin(dim=0),
                "mv_sel": take_mv(mv_stack, k),
                "bits_sel": take(bits_stack, k),
                "c_ch": take(c_stack, kc), "mv_ch": take_mv(mv_stack, kc),
                "bits_ch": take(bits_stack, kc)}
        # the finalists (SATD winner and cheapest merge-class candidate)
        # regenerated from their MVs: one launch for every size
        preds = iter(_mc_luma(exts[li], torch.stack(
            [up_mv(uni[li][s][key], s // 8) for s in sizes
             for key in ("mv_sel", "mv_ch")]), bit_depth, True))
        for s in sizes:
            uni[li][s]["p_sel"] = next(preds)
            uni[li][s]["p_ch"] = next(preds)

    leaf_cost, leaf_mode = {}, {}
    leaf_mv0, leaf_mv1, leaf_u0, leaf_u1 = {}, {}, {}, {}
    for s in sizes:
        rep = s // 8
        u0, u1 = uni[0][s], uni[1][s]
        c0, c1 = u0["c"], u1["c"]
        mv0, mv1 = (md[f"mv{s}"].to(torch.int32) for md in (md0, md1))
        if s >= 16:
            pred_bi = ((u0["raw"] + u1["raw"] + (1 << (s_b - 1))) >> s_b
                       ).clamp(0, maxval)
            cbi = (satd_of(pred_bi, rep)
                   + lam * (u0["b_me"] + u1["b_me"] + 6)).to(torch.int32)
        else:
            pred_bi = _round_uni(u0["raw"], bit_depth)
            cbi = torch.full_like(c0, INF)
        if 32 >= s >= (1 << min_intra_log2):
            mode_map, cost_map = ois[s]
            intra_c = 2 * cost_map + lam * 6
            fails = torch.minimum(c0, c1) > (lam * s * s) >> 1
            intra_c = torch.where(fails, intra_c, INF)
        else:
            intra_c = torch.full_like(c0, INF)
            mode_map = torch.zeros_like(c0)
        best = torch.minimum(torch.minimum(c0, c1),
                             torch.minimum(cbi, intra_c))
        is_bi = best == cbi
        is_1 = (best == c1) & ~is_bi
        is_0 = (best == c0) & ~is_bi & ~is_1
        is_intra = ~(is_bi | is_1 | is_0)

        # ---- stage 2: true RD between the SATD winner and the cheapest
        # merge-class candidate across both lists
        pred_win = torch.where(_rep(is_bi, s), pred_bi,
                               torch.where(_rep(is_1, s), u1["p_sel"],
                                           u0["p_sel"]))
        bits_win = torch.where(is_bi, u0["b_me"] + u1["b_me"] + 6,
                               torch.where(is_1, u1["bits_sel"],
                                           u0["bits_sel"]))
        ch_is_1 = u1["c_ch"] < u0["c_ch"]
        pred_ch = torch.where(_rep(ch_is_1, s), u1["p_ch"], u0["p_ch"])
        bits_ch = torch.where(ch_is_1, u1["bits_ch"], u0["bits_ch"])
        j_sel = _rd_leaf_cost(srcf, pred_win, s, qp, lam_sse, bits_win,
                              bit_depth)
        j_ch = _rd_leaf_cost(srcf, pred_ch, s, qp, lam_sse, bits_ch,
                             bit_depth)
        use_ch = (j_ch < j_sel) & ~is_intra
        inter_j = torch.where(use_ch, j_ch, j_sel)
        zero = torch.zeros_like(mv0)
        uc, c1v = use_ch[..., None], ch_is_1[..., None]
        leaf_mv0[s] = torch.where(
            uc, torch.where(c1v, zero, u0["mv_ch"]),
            torch.where(is_bi[..., None], mv0,
                        torch.where(is_0[..., None], u0["mv_sel"], zero)))
        leaf_mv1[s] = torch.where(
            uc, torch.where(c1v, u1["mv_ch"], zero),
            torch.where(is_bi[..., None], mv1,
                        torch.where(is_1[..., None], u1["mv_sel"], zero)))
        leaf_u0[s] = torch.where(use_ch, ~ch_is_1, is_0 | is_bi)
        leaf_u1[s] = torch.where(use_ch, ch_is_1, is_1 | is_bi)
        leaf_cost[s] = torch.where(
            is_intra,
            torch.clamp_max(j_ratio * intra_c.to(torch.float32), 3e37),
            inter_j)
        leaf_mode[s] = torch.where(is_intra, mode_map.to(torch.int32), 0)

    split_charge = _f32(np.float32(lam_sse) * np.float32(3.0))
    best = {8: leaf_cost[8]}
    split = {}
    for s in sizes[1:]:
        agg = _boxsum(best[s // 2], 2) + split_charge
        gy, gx = leaf_cost[s].shape
        cross = (((torch.arange(gx, device=dev) * s + s) > w)[None, :]
                 | ((torch.arange(gy, device=dev) * s + s) > h)[:, None])
        split[s] = (agg < leaf_cost[s]) | cross
        best[s] = torch.where(split[s], agg, leaf_cost[s])

    nby, nbx = leaf_cost[8].shape
    cu_log2 = torch.zeros((nby, nbx), dtype=torch.int32, device=dev)
    u0 = torch.zeros((nby, nbx), dtype=torch.bool, device=dev)
    u1 = torch.zeros((nby, nbx), dtype=torch.bool, device=dev)
    mv8_0 = torch.zeros((nby, nbx, 2), dtype=torch.int32, device=dev)
    mv8_1 = torch.zeros((nby, nbx, 2), dtype=torch.int32, device=dev)
    mode8 = torch.zeros((nby, nbx), dtype=torch.int32, device=dev)
    undecided = torch.ones((nby, nbx), dtype=torch.bool, device=dev)
    for s in reversed(sizes):
        k = s // 8
        leaf_here = undecided if s == 8 else undecided & ~_rep(split[s], k)
        cu_log2 = torch.where(leaf_here, s.bit_length() - 1, cu_log2)
        u0 = torch.where(leaf_here, _rep(leaf_u0[s], k), u0)
        u1 = torch.where(leaf_here, _rep(leaf_u1[s], k), u1)
        lh = leaf_here[..., None]
        mv8_0 = torch.where(lh, _rep(leaf_mv0[s], k), mv8_0)
        mv8_1 = torch.where(lh, _rep(leaf_mv1[s], k), mv8_1)
        mode8 = torch.where(leaf_here, _rep(leaf_mode[s], k), mode8)
        undecided = undecided & ~leaf_here
    ref8_2 = torch.stack([torch.where(u0, 0, -1), torch.where(u1, 0, -1)])
    return (cu_log2.to(torch.int32), ref8_2.to(torch.int32),
            torch.stack([mv8_0, mv8_1]).to(torch.int32), mode8.to(torch.int32))


# ------------------------------------------------------- fused I-picture path

def decide_tree_i_dev(ois: dict, qp: int, ctb_log2: int, w: int, h: int,
                      src=None, preds: dict | None = None,
                      bit_depth: int = 8):
    """Intra-only quadtree DP (sizes 8/16/32). With src + preds the
    leaves are costed by true RD. Returns (cu_log2_8, mode8)."""
    INF = 3e37 if src is not None else 1 << 28
    lam = int(LAMBDA_SAD[qp])
    lam_sse = float(_LAM_SSE_I[qp])
    sizes = [s for s in (8, 16, 32) if (1 << ctb_log2) >= s]

    leaf_cost, leaf_mode = {}, {}
    for s in sizes:
        mode_map, cost_map = ois[s]
        dev = mode_map.device
        gy, gx = cost_map.shape
        ok = (((torch.arange(gx, device=dev) * s + s) <= w)[None, :]
              & ((torch.arange(gy, device=dev) * s + s) <= h)[:, None])
        if src is not None:
            j = _rd_leaf_cost(src, preds[s], s, qp, lam_sse, 4.0,
                              bit_depth, is_intra=True)
            leaf_cost[s] = torch.where(ok, j, INF)
        else:
            leaf_cost[s] = torch.where(ok, 2 * cost_map + lam * 3, INF)
        leaf_mode[s] = mode_map.to(torch.int32)

    charge = (_f32(np.float32(lam_sse) * np.float32(3.0))
              if src is not None else lam * 2)
    best = {sizes[0]: leaf_cost[sizes[0]]}
    split = {}
    for s in sizes[1:]:
        agg = _boxsum(best[s // 2], 2) + charge
        split[s] = (agg < leaf_cost[s]) | (leaf_cost[s] >= INF)
        best[s] = torch.clamp_max(torch.where(split[s], agg, leaf_cost[s]),
                                  INF)

    dev = leaf_cost[8].device
    nby, nbx = leaf_cost[8].shape
    cu_log2 = torch.full((nby, nbx), 3, dtype=torch.int32, device=dev)
    mode8 = torch.zeros((nby, nbx), dtype=torch.int32, device=dev)
    undecided = torch.ones((nby, nbx), dtype=torch.bool, device=dev)
    for s in reversed(sizes):
        k = s // 8
        leaf_here = undecided if s == 8 else undecided & ~_rep(split[s], k)
        cu_log2 = torch.where(leaf_here, s.bit_length() - 1, cu_log2)
        mode8 = torch.where(leaf_here, _rep(leaf_mode[s], k), mode8)
        undecided = undecided & ~leaf_here
    return cu_log2.to(torch.int32), mode8.to(torch.int32)


# --------------------------------------------- device-resident fused encodes

def _compact4(lv, nz4):
    """(buf (cap, 16) int16, count): the nonzero 4x4 coefficient groups of
    `lv` compacted in scan order by a prefix-sum scatter. Groups beyond
    `cap` (and every zero group) go to one spare row that is dropped, so
    no two kept groups share a destination."""
    hh, ww = lv.shape
    ng = (hh // 4) * (ww // 4)
    cap = max(ng // COMPACT_CAP_FRAC, 1)
    g = (lv.reshape(hh // 4, 4, ww // 4, 4).permute(0, 2, 1, 3)
         .reshape(ng, 16).to(torch.int16))
    m = nz4.reshape(ng)
    idx = torch.cumsum(m.to(torch.int32), 0) - 1
    dest = torch.where(m & (idx < cap), idx, cap)
    buf = torch.zeros((cap + 1, 16), dtype=torch.int16, device=lv.device)
    buf.index_put_((dest,), g)
    return buf[:cap], m.to(torch.int32).sum(dtype=torch.int32)


def compact_specs(h64: int, w64: int):
    """Download layout of the compacted coefficient section."""
    cap_y = max((h64 // 4) * (w64 // 4) // COMPACT_CAP_FRAC, 1)
    cap_c = max((h64 // 8) * (w64 // 8) // COMPACT_CAP_FRAC, 1)
    return [("lvc_y", (cap_y, 16), np.int16),
            ("lvc_cb", (cap_c, 16), np.int16),
            ("lvc_cr", (cap_c, 16), np.int16),
            ("lv_counts", (3, 2), np.int32)]


def _cbf4_map(lv_y, tu_log2_8):
    """Per-4x4 luma cbf of the covering TU (deblocking bS input)."""
    out = None
    for lg in (3, 4, 5):
        n = 1 << lg
        anyn = _boxsum(lv_y.abs(), n) > 0
        rep = _rep(anyn, n // 4)
        m = _rep(tu_log2_8 == lg, 2)
        out = torch.where(m, rep, out if out is not None else False)
    return out.to(torch.int32)


def _edge_pad_to(rec, w: int, h: int):
    """Replicate the coded boundary into the 64-aligned pad region."""
    hh, ww = rec.shape
    iy = torch.arange(hh, device=rec.device).clamp(0, h - 1)
    ix = torch.arange(ww, device=rec.device).clamp(0, w - 1)
    return rec.index_select(0, iy).index_select(1, ix)


def _finish_fused(src3, rec3, lv3, cu_log2_8, inter8, mv8, tu8, qp: int,
                  qp_c: int, lam: float, ctb_log2: int, w: int, h: int,
                  bit_depth: int, dlf: bool, sao: bool, refpoc8=None,
                  mv8_2l=None):
    """Shared fused tail: cbf map -> DLF -> SAO decide + apply -> edge
    pad, then pack everything the host needs (no recon planes).
    refpoc8/mv8_2l: two-list motion for the B-picture bS rule."""
    from .dlf import deblock_dev, derive_bs_maps
    from .sao import sao_apply_dev, sao_decide_dev

    src_y, src_cb, src_cr = src3
    rec_y, rec_cb, rec_cr = rec3
    lv_y, lv_cb, lv_cr = lv3
    h64, w64 = src_y.shape
    dev = src_y.device
    ctb = 1 << ctb_log2
    ny, nx = h64 // ctb, w64 // ctb

    if dlf:
        cbf4 = _cbf4_map(lv_y, tu8)
        bs_v, bs_ht = derive_bs_maps(cu_log2_8, inter8, mv8, cbf4, w, h,
                                     tu_log2_8=tu8, refpoc8=refpoc8,
                                     mv8_2l=mv8_2l)
        rec_y, rec_cb, rec_cr = deblock_dev(rec_y, rec_cb, rec_cr, bs_v,
                                            bs_ht, qp, qp_c,
                                            bit_depth=bit_depth)
    if sao:
        stats = []
        for comp, (rec, src) in enumerate(((rec_y, src_y), (rec_cb, src_cb),
                                           (rec_cr, src_cr))):
            cell = ctb if comp == 0 else ctb // 2
            hv = h if comp == 0 else h // 2
            wv = w if comp == 0 else w // 2
            hh, ww = rec.shape
            valid = ((torch.arange(hh, device=dev)[:, None] < hv)
                     & (torch.arange(ww, device=dev)[None, :] < wv)
                     ).to(torch.float32)
            stats.append(sao_stats_plane(rec, src, valid, cell, cell,
                                         bit_depth=bit_depth))
        params = sao_decide_dev(stats, lam, bit_depth=bit_depth)
        rec_y = sao_apply_dev(rec_y, params, 0, ctb, w, h,
                              bit_depth=bit_depth)
        rec_cb = sao_apply_dev(rec_cb, params, 1, ctb, w // 2, h // 2,
                               bit_depth=bit_depth)
        rec_cr = sao_apply_dev(rec_cr, params, 2, ctb, w // 2, h // 2,
                               bit_depth=bit_depth)
    else:
        def z(*s):
            return torch.zeros(s, dtype=torch.int32, device=dev)
        params = {"type": z(ny, nx, 2), "eo": z(ny, nx, 2),
                  "bp": z(ny, nx, 3), "offs": z(ny, nx, 3, 4)}

    rec_y = _edge_pad_to(rec_y, w, h)
    rec_cb = _edge_pad_to(rec_cb, w // 2, h // 2)
    rec_cr = _edge_pad_to(rec_cr, w // 2, h // 2)

    nz_y = _nz_map(lv_y, 4)
    nz_cb = _nz_map(lv_cb, 4)
    nz_cr = _nz_map(lv_cr, 4)
    buf_y, cnt_y = _compact4(lv_y, nz_y)
    buf_cb, cnt_cb = _compact4(lv_cb, nz_cb)
    buf_cr, cnt_cr = _compact4(lv_cr, nz_cr)
    cnts = torch.stack([cnt_y, cnt_cb, cnt_cr])
    arrs = [buf_y, buf_cb, buf_cr,
            torch.stack([cnts & 0x3FFF, cnts >> 14], -1),
            nz_y, nz_cb, nz_cr,
            params["type"], params["eo"], params["bp"], params["offs"]]
    return (_pack(arrs, torch.int16), rec_y, rec_cb, rec_cr,
            (lv_y.to(torch.int16), lv_cb.to(torch.int16),
             lv_cr.to(torch.int16)))


def dec_specs(h64: int, w64: int):
    nby, nbx = h64 // 8, w64 // 8
    return [("cu_log2_8", (nby, nbx), np.int32),
            ("inter8", (nby, nbx), bool),
            ("mv8", (nby, nbx, 2), np.int32),
            ("intra_mode8", (nby, nbx), np.int32),
            ("tu_log2_8", (nby, nbx), np.int32)]


def finish_specs(h64: int, w64: int, ctb: int):
    ny, nx = h64 // ctb, w64 // ctb
    return compact_specs(h64, w64) + [
        ("nz4_y", (h64 // 4, w64 // 4), bool),
        ("nz4_cb", (h64 // 8, w64 // 8), bool),
        ("nz4_cr", (h64 // 8, w64 // 8), bool),
        ("sao_type", (ny, nx, 2), np.int32),
        ("sao_eo", (ny, nx, 2), np.int32),
        ("sao_bp", (ny, nx, 3), np.int32),
        ("sao_offs", (ny, nx, 3, 4), np.int32)]


def fused_dev_specs(h64: int, w64: int, ctb: int):
    return dec_specs(h64, w64) + finish_specs(h64, w64, ctb)


def b_dec_specs(h64: int, w64: int):
    nby, nbx = h64 // 8, w64 // 8
    return [("cu_log2_8", (nby, nbx), np.int32),
            ("ref8", (2, nby, nbx), np.int32),
            ("mv8_2l", (2, nby, nbx, 2), np.int32),
            ("intra_mode8", (nby, nbx), np.int32),
            ("tu_log2_8", (nby, nbx), np.int32)]


def fused_b_dev_specs(h64: int, w64: int, ctb: int):
    return b_dec_specs(h64, w64) + finish_specs(h64, w64, ctb)


def merge_snap(src, ref_ext4, mv8, inter8, cu_log2_8, qp: int, col16_mv,
               col16_valid, tb: int, td: int, ctb_log2: int, w: int, h: int,
               bit_depth: int = 8):
    """Post-decision merge alignment pass: snap each leaf CU's MV to its
    best real merge candidate (A1 / B1 / TMVP, read from the DECIDED
    field at the spec positions) when that candidate's SATD cost is
    within SNAP_BIAS_BITS of the decided MV's AMVP-priced cost."""
    dev = src.device
    srcf = src.to(torch.int32)
    lam = 2 * int(LAMBDA_SAD[qp])
    lim_q = (PAD - 9) * 4
    nby, nbx = inter8.shape
    out = mv8
    col16 = None
    if col16_mv is not None:
        col16 = _scale_mv_dev(col16_mv.to(torch.int32), tb, td)
    # every size's candidates read the input field mv8, never `out`, so
    # the decided field and all candidates go into one K2 launch
    per_size = []
    fields = [mv8]
    for s in (8, 16, 32, 64):
        if (1 << ctb_log2) < s:
            continue
        k = s // 8
        lg = s.bit_length() - 1
        gy, gx = nby // k, nbx // k
        leaf = (cu_log2_8[::k, ::k] == lg) & inter8[::k, ::k]
        mv_cu = mv8[::k, ::k]
        ar_y = torch.arange(gy, device=dev)
        ar_x = torch.arange(gx, device=dev)
        rA1 = ar_y * k + (k - 1)
        cA1 = (ar_x * k - 1).clamp_min(0)
        rB1 = (ar_y * k - 1).clamp_min(0)
        cB1 = ar_x * k + (k - 1)
        vA1 = (ar_x > 0)[None, :] & inter8[rA1[:, None], cA1[None, :]]
        mvA1 = mv8[rA1[:, None], cA1[None, :]]
        vB1 = (ar_y > 0)[:, None] & inter8[rB1[:, None], cB1[None, :]]
        mvB1 = mv8[rB1[:, None], cB1[None, :]]
        cands = [(mvA1, vA1, 2), (mvB1, vB1, 3)]
        if col16 is not None:
            mv_t, v_t = _tmvp_candidate(col16, col16_valid, s, (gy, gx),
                                        ctb_log2, w, h)
            cands.append((mv_t.clamp(-lim_q, lim_q), v_t, 5))
        fields += [_rep(mv_c, k) for mv_c, _, _ in cands]
        per_size.append((k, leaf, mv_cu, mvA1, cands))
    preds = iter(_mc_luma(ref_ext4, torch.stack(fields), bit_depth, True))

    satd8_dec = _satd8_map(srcf - next(preds))
    for k, leaf, mv_cu, mvA1, cands in per_size:
        gy, gx = nby // k, nbx // k
        d_dec = _boxsum(satd8_dec, k)
        bits_dec = (_mvd_bits_dev(mv_cu[..., 0] - mvA1[..., 0])
                    + _mvd_bits_dev(mv_cu[..., 1] - mvA1[..., 1])
                    + AMVP_BASE_BITS)
        j_dec = d_dec + lam * bits_dec
        best_j = torch.full((gy, gx), 1 << 30, dtype=torch.int32,
                            device=dev)
        best_mv = mv_cu
        already = torch.zeros((gy, gx), dtype=torch.bool, device=dev)
        for mv_c, v_c, bits_c in cands:
            same = (mv_c == mv_cu).all(-1) & v_c
            already = already | same
            satd = _boxsum(_satd8_map(srcf - next(preds)), k)
            j_c = torch.where(v_c, satd + lam * bits_c, 1 << 30)
            take = j_c < best_j
            best_j = torch.where(take, j_c, best_j)
            best_mv = torch.where(take[..., None], mv_c, best_mv)
        snap = leaf & ~already & (best_j <= j_dec + lam * SNAP_BIAS_BITS)
        new_cu = torch.where(snap[..., None], best_mv, mv_cu)
        leaf_up = _rep(leaf & snap, k)
        out = torch.where(leaf_up[..., None], _rep(new_cu, k), out)
    return out


def merge_snap_b(src, ext0, ext1, mv8_2l, ref8_2l, cu_log2_8, qp: int,
                 ctb_log2: int, w: int, h: int, bit_depth: int = 8):
    """Two-list merge alignment for B pictures (see merge_snap): a B CU
    merges only when its whole motion (both lists' use flags and MVs)
    equals a real merge candidate's, so the snap adopts the A1 / B1
    neighbour's full motion (uni-L0 / uni-L1 / bi). Every candidate reads
    the input field, so each list's decided field and every size's A1 / B1
    fields go into one K2 launch. Returns (mv8_2l, ref8_2l)."""
    srcf = src.to(torch.int32)
    dev = srcf.device
    lam = 2 * int(LAMBDA_SAD[qp])
    nby, nbx = cu_log2_8.shape
    inter_any = (ref8_2l >= 0).any(0)
    u0_f = ref8_2l[0] >= 0
    u1_f = ref8_2l[1] >= 0

    per_size = []
    fields = ([mv8_2l[0]], [mv8_2l[1]])
    for s in (8, 16, 32, 64):
        if (1 << ctb_log2) < s:
            continue
        k = s // 8
        gy, gx = nby // k, nbx // k
        ar_y = torch.arange(gy, device=dev)
        ar_x = torch.arange(gx, device=dev)
        rA1, cA1 = ar_y * k + (k - 1), ar_x * k - 1
        rB1, cB1 = ar_y * k - 1, ar_x * k + (k - 1)

        def nb(rr, cc, ok):
            ri = rr.clamp_min(0)[:, None]
            ci = cc.clamp_min(0)[None, :]
            return (mv8_2l[:, ri, ci], torch.stack([u0_f[ri, ci],
                                                    u1_f[ri, ci]]),
                    ok & inter_any[ri, ci])

        cands = (nb(rA1, cA1, (cA1 >= 0)[None, :]),
                 nb(rB1, cB1, (rB1 >= 0)[:, None]))
        for mvn, _, _ in cands:
            for li in (0, 1):
                fields[li].append(_rep(mvn[li], k))
        per_size.append((s, k, cands))
    raws = iter(zip(*(_mc_luma(ext, torch.stack(f), bit_depth, False)
                      for ext, f in ((ext0, fields[0]),
                                     (ext1, fields[1])))))
    satd8_dec = _satd8_map(srcf - _bi_select(*next(raws), u0_f, u1_f, 8,
                                             bit_depth))

    out_mv = mv8_2l
    out_ref = ref8_2l
    for s, k, cands in per_size:
        lg = s.bit_length() - 1
        gy, gx = nby // k, nbx // k
        leaf = (cu_log2_8[::k, ::k] == lg) & inter_any[::k, ::k]
        mv_cu = mv8_2l[:, ::k, ::k]
        u_cu = torch.stack([u0_f[::k, ::k], u1_f[::k, ::k]])
        d_dec = _boxsum(satd8_dec, k)
        # the decided motion at AMVP pricing: per used list, the MVD
        # against the A1 MV
        mvA = cands[0][0]
        bits_dec = torch.full((gy, gx), AMVP_BASE_BITS, dtype=torch.int32,
                              device=dev)
        for li in range(2):
            bl = (_mvd_bits_dev(mv_cu[li, ..., 0] - mvA[li, ..., 0])
                  + _mvd_bits_dev(mv_cu[li, ..., 1] - mvA[li, ..., 1]))
            bits_dec = bits_dec + torch.where(u_cu[li], bl, 0)
        j_dec = d_dec + lam * bits_dec

        best_j = torch.full((gy, gx), 1 << 30, dtype=torch.int32,
                            device=dev)
        best_mv = mv_cu
        best_u = u_cu
        already = torch.zeros((gy, gx), dtype=torch.bool, device=dev)
        for (mvn, un, vn), bits_c in zip(cands, (2, 3)):
            same = ((mvn == mv_cu).all(0).all(-1) & (un == u_cu).all(0)
                    & vn)
            already = already | same
            pred_c = _bi_select(*next(raws), _rep(un[0], k),
                                _rep(un[1], k), 8, bit_depth)
            d_c = _boxsum(_satd8_map(srcf - pred_c), k)
            j_c = torch.where(vn, d_c + lam * bits_c, 1 << 30)
            take = j_c < best_j
            best_j = torch.where(take, j_c, best_j)
            best_mv = torch.where(take[None, ..., None], mvn, best_mv)
            best_u = torch.where(take[None], un, best_u)
        snap = leaf & ~already & (best_j <= j_dec + lam * SNAP_BIAS_BITS)
        sn_up = _rep(leaf & snap, k)
        new_mv = torch.where(snap[None, ..., None], best_mv, mv_cu)
        new_u = torch.where(snap[None], best_u, u_cu)
        out_mv = torch.where(sn_up[None, ..., None],
                             torch.stack([_rep(new_mv[0], k),
                                          _rep(new_mv[1], k)]), out_mv)
        new_ref = torch.where(new_u, 0, -1).to(out_ref.dtype)
        out_ref = torch.where(sn_up[None],
                              torch.stack([_rep(new_ref[0], k),
                                           _rep(new_ref[1], k)]), out_ref)
    return out_mv, out_ref


def _fast_p_front(src_y, ref_y, hme_mv, qp: int, col16_mv, col16_valid,
                  tb: int, td: int, ctb_log2: int, w: int, h: int,
                  bit_depth: int = 8,
                  min_intra_log2: int = P_MIN_INTRA_LOG2,
                  subpel_min: int = 16):
    """P-picture front half: dense MD + OIS + quadtree decision + merge
    alignment passes. The open-loop intra search runs only when the
    decision offers intra (min_intra_log2 <= 5); otherwise the decision
    never reads it."""
    from .analysis import intra_search_size

    with stage("p.dense_md_p"):
        md = dense_md_p(src_y, ref_y, hme_mv, bit_depth=bit_depth, qp=qp,
                        subpel_min=subpel_min)
    ois = {}
    if min_intra_log2 <= 5:
        yf = src_y.to(torch.float32)
        for n in (16, 32):
            mode, cost = intra_search_size(yf, n)
            ois[n] = (mode.to(torch.int32),
                      torch.round(cost).to(torch.int32))
    with stage("p.decide_tree_dev"):
        cu_log2_8, inter8, mv8, mode8 = decide_tree_dev(
            md, ois, ctb_log2, min_intra_log2=min_intra_log2, w=w, h=h,
            qp=qp, src=src_y, ref=ref_y, bit_depth=bit_depth,
            col_mv8=col16_mv, col_valid8=col16_valid, tb=tb, td=td)
    ext4 = _ext_y(ref_y)
    for _ in range(SNAP_PASSES):
        with stage("p.merge_snap"):
            mv8 = merge_snap(src_y, ext4, mv8, inter8, cu_log2_8, qp,
                             col16_mv, col16_valid, tb, td,
                             ctb_log2=ctb_log2, w=w, h=h,
                             bit_depth=bit_depth)
    return cu_log2_8, inter8, mv8, mode8


def _intra_fixup(src3, rec3, lv3, cu_log2_8, inter8, mode8, qp: int,
                 qp_c: int, lam: float, ctb_log2: int, w: int, h: int,
                 bit_depth: int, min_intra_log2: int, kind: str):
    """Closed-loop intra encode of the intra CUs an inter picture's
    decision chose (presets M8-M9): the JAX graphs' lax.cond over
    any_intra, taken here with one host read of any_intra (a device
    sync). Neighbour samples come from the inter CUs' reconstruction in
    rec3. Returns (rec3, lv3, mode8), unchanged where no in-picture 8x8
    block is intra."""
    from .intra_pass import intra_wavefront_pass

    nby, nbx = cu_log2_8.shape
    dev = cu_log2_8.device
    inpic = ((torch.arange(nbx, device=dev) * 8 < w)[None, :]
             & (torch.arange(nby, device=dev) * 8 < h)[:, None])
    with stage(f"{kind}.any_intra", wait=True):
        any_intra = bool((~inter8 & inpic).any())
    if not any_intra:
        return rec3, lv3, mode8
    with stage(f"{kind}.intra_wavefront_pass"):
        out7 = intra_wavefront_pass(
            *src3, *rec3, *lv3, cu_log2_8, mode8, ~inter8, qp, qp_c, w=w,
            h=h, bit_depth=bit_depth, ctb_log2=ctb_log2,
            min_cu_log2=min_intra_log2, lam=lam, refine_modes=True)
    return out7[:3], out7[3:6], out7[6]


def _fast_p_finish(src_y, src_cb, src_cr, ref_y, ref_cb, ref_cr,
                   cu_log2_8, inter8, mv8, mode8, qp: int, qp_c: int,
                   lam: float, ctb_log2: int, w: int, h: int,
                   bit_depth: int = 8, dlf: bool = True, sao: bool = True,
                   min_intra_log2: int = P_MIN_INTRA_LOG2):
    """P-picture finish half: encode pass + intra fixup (where the
    preset offers intra, min_intra_log2 <= 5) + DLF/SAO + pack."""
    tu_log2 = torch.clamp_max(cu_log2_8, 5)
    with stage("p.encode_pass_p_direct"):
        out = encode_pass_p_direct(
            src_y, src_cb, src_cr, ref_y, ref_cb, ref_cr, mv8, inter8,
            tu_log2, qp, qp_c, bit_depth=bit_depth,
            lam=_f32(np.float32(lam) * np.float32(INTER_ZERO_LAMBDA_SCALE)),
            tu_split=True, cu_log2_8=cu_log2_8)
    tu8 = out["tu8"]
    rec3 = (out["rec_y"], out["rec_cb"], out["rec_cr"])
    lv3 = (out["lv_y"], out["lv_cb"], out["lv_cr"])
    if min_intra_log2 < 6:
        rec3, lv3, mode8 = _intra_fixup(
            (src_y, src_cb, src_cr), rec3, lv3, cu_log2_8, inter8, mode8,
            qp, qp_c, lam, ctb_log2, w, h, bit_depth, min_intra_log2, "p")
    with stage("p._finish_fused"):
        packed_fin, rec_y, rec_cb, rec_cr, lv_full = _finish_fused(
            (src_y, src_cb, src_cr), rec3, lv3, cu_log2_8, inter8, mv8, tu8,
            qp, qp_c, lam, ctb_log2, w, h, bit_depth, dlf, sao)
    packed = torch.cat(
        [_pack([cu_log2_8, inter8, mv8, mode8, tu8], torch.int16),
         packed_fin])
    return (packed, rec_y, rec_cb, rec_cr,
            mv8[::2, ::2].contiguous(), inter8[::2, ::2].contiguous(),
            lv_full)


def fast_p_fused_dev(src_y, src_cb, src_cr, ref_y, ref_cb, ref_cr, hme_mv,
                     qp: int, qp_c: int, lam: float, col16_mv, col16_valid,
                     tb: int, td: int, ctb_log2: int, w: int, h: int,
                     bit_depth: int = 8, dlf: bool = True, sao: bool = True,
                     min_intra_log2: int = P_MIN_INTRA_LOG2,
                     subpel_min: int = 16):
    """Device-resident P-picture pipeline (front: dense MD + decision +
    merge snap; finish: encode pass, DLF + SAO, pack). Returns (packed,
    rec_y, rec_cb, rec_cr, col16_mv_out, col16_valid_out, lv_full)."""
    cu_log2_8, inter8, mv8, mode8 = _fast_p_front(
        src_y, ref_y, hme_mv, qp, col16_mv, col16_valid, tb, td,
        ctb_log2=ctb_log2, w=w, h=h, bit_depth=bit_depth,
        min_intra_log2=min_intra_log2, subpel_min=subpel_min)
    return _fast_p_finish(
        src_y, src_cb, src_cr, ref_y, ref_cb, ref_cr,
        cu_log2_8, inter8, mv8, mode8, qp, qp_c, lam,
        ctb_log2=ctb_log2, w=w, h=h, bit_depth=bit_depth, dlf=dlf,
        sao=sao, min_intra_log2=min_intra_log2)


def _fast_b_front(src_y, src_cb, src_cr, ref0_y, ref0_cb, ref0_cr,
                  ref1_y, ref1_cb, ref1_cr, hme_mv0, hme_mv1, qp: int,
                  qp_c: int, lam: float, ctb_log2: int, w: int, h: int,
                  bit_depth: int = 8,
                  min_intra_log2: int = P_MIN_INTRA_LOG2,
                  subpel_min: int = 16):
    """B-picture front half: dense MD per list, the two-list quadtree
    decision, merge alignment passes, the B encode pass and, where the
    preset offers intra (min_intra_log2 <= 5), the intra fixup. Where
    both lists hold the same reference and HME field (low-delay B), the
    second list's dense MD is the first's."""
    from .analysis import intra_search_size

    with stage("b.dense_md_p"):
        md0 = dense_md_p(src_y, ref0_y, hme_mv0, bit_depth=bit_depth, qp=qp,
                         subpel_min=subpel_min)
    if ref1_y is ref0_y and hme_mv1 is hme_mv0:
        md1 = md0
    else:
        with stage("b.dense_md_p"):
            md1 = dense_md_p(src_y, ref1_y, hme_mv1, bit_depth=bit_depth,
                             qp=qp, subpel_min=subpel_min)
    ois = {}
    if min_intra_log2 <= 5:
        yf = src_y.to(torch.float32)
        for n in (16, 32):
            mode, cost = intra_search_size(yf, n)
            ois[n] = (mode.to(torch.int32),
                      torch.round(cost).to(torch.int32))
    with stage("b.decide_tree_b_dev"):
        cu_log2_8, ref8_2l, mv8_2l, mode8 = decide_tree_b_dev(
            md0, md1, ois, ctb_log2, src_y, ref0_y, ref1_y,
            min_intra_log2=min_intra_log2, w=w, h=h, qp=qp,
            bit_depth=bit_depth)
    ext0 = _ext_y(ref0_y)
    ext1 = ext0 if ref1_y is ref0_y else _ext_y(ref1_y)
    for _ in range(SNAP_PASSES):
        with stage("b.merge_snap_b"):
            mv8_2l, ref8_2l = merge_snap_b(
                src_y, ext0, ext1, mv8_2l, ref8_2l, cu_log2_8, qp,
                ctb_log2=ctb_log2, w=w, h=h, bit_depth=bit_depth)
    with stage("b.encode_pass_b_direct"):
        out = encode_pass_b_direct(
            src_y, src_cb, src_cr, (ref0_y, ref0_cb, ref0_cr),
            (ref1_y, ref1_cb, ref1_cr), mv8_2l, ref8_2l,
            torch.clamp_max(cu_log2_8, 5), qp, qp_c, bit_depth=bit_depth,
            lam=_f32(np.float32(lam) * np.float32(INTER_ZERO_LAMBDA_SCALE)),
            tu_split=True, cu_log2_8=cu_log2_8)
    rec3 = (out["rec_y"], out["rec_cb"], out["rec_cr"])
    lv3 = (out["lv_y"], out["lv_cb"], out["lv_cr"])
    if min_intra_log2 < 6:
        rec3, lv3, mode8 = _intra_fixup(
            (src_y, src_cb, src_cr), rec3, lv3, cu_log2_8,
            (ref8_2l >= 0).any(0), mode8, qp, qp_c, lam, ctb_log2, w, h,
            bit_depth, min_intra_log2, "b")
    return cu_log2_8, ref8_2l, mv8_2l, mode8, out["tu8"], rec3, lv3


def _fast_b_finish(src_y, src_cb, src_cr, cu_log2_8, ref8_2l, mv8_2l,
                   mode8, tu8, rec3, lv3, poc_delta0: int, poc_delta1: int,
                   qp: int, qp_c: int, lam: float, ctb_log2: int, w: int,
                   h: int, bit_depth: int = 8, dlf: bool = True,
                   sao: bool = True):
    """B-picture finish half: DLF (two-list bS rule) + SAO + pack. The
    bS rule compares reference POCs; with the current POC as 0 the
    per-list POC deltas serve (only equality and order matter)."""
    inter8 = (ref8_2l >= 0).any(0)
    refpoc8 = torch.stack([
        torch.where(ref8_2l[0] >= 0, poc_delta0, _POC_NONE),
        torch.where(ref8_2l[1] >= 0, poc_delta1, _POC_NONE)]).to(torch.int32)
    with stage("b._finish_fused"):
        packed_fin, rec_y, rec_cb, rec_cr, lv_full = _finish_fused(
            (src_y, src_cb, src_cr), rec3, lv3, cu_log2_8, inter8,
            mv8_2l[0], tu8, qp, qp_c, lam, ctb_log2, w, h, bit_depth, dlf,
            sao, refpoc8=refpoc8, mv8_2l=mv8_2l)
    packed = torch.cat(
        [_pack([cu_log2_8, ref8_2l, mv8_2l, mode8, tu8], torch.int16),
         packed_fin])
    return packed, rec_y, rec_cb, rec_cr, lv_full


def fast_b_fused_dev(src_y, src_cb, src_cr, ref0_y, ref0_cb, ref0_cr,
                     ref1_y, ref1_cb, ref1_cr, hme_mv0, hme_mv1,
                     poc_delta0: int, poc_delta1: int, qp: int, qp_c: int,
                     lam: float, ctb_log2: int, w: int, h: int,
                     bit_depth: int = 8, dlf: bool = True, sao: bool = True,
                     min_intra_log2: int = P_MIN_INTRA_LOG2,
                     subpel_min: int = 16):
    """Device-resident B-picture pipeline (front: dense MD per list,
    decision, merge snap, encode pass; finish: DLF with the two-list bS
    rule, SAO, pack). Returns (packed, rec_y, rec_cb, rec_cr,
    col16_mv_out, col16_valid_out, lv_full); the collocated output is the
    decided motion, L0-preferred, 16x16-compressed."""
    cu_log2_8, ref8_2l, mv8_2l, mode8, tu8, rec3, lv3 = _fast_b_front(
        src_y, src_cb, src_cr, ref0_y, ref0_cb, ref0_cr, ref1_y, ref1_cb,
        ref1_cr, hme_mv0, hme_mv1, qp, qp_c, lam, ctb_log2=ctb_log2, w=w,
        h=h, bit_depth=bit_depth, min_intra_log2=min_intra_log2,
        subpel_min=subpel_min)
    packed, rec_y, rec_cb, rec_cr, lv_full = _fast_b_finish(
        src_y, src_cb, src_cr, cu_log2_8, ref8_2l, mv8_2l, mode8, tu8,
        rec3, lv3, poc_delta0, poc_delta1, qp, qp_c, lam,
        ctb_log2=ctb_log2, w=w, h=h, bit_depth=bit_depth, dlf=dlf, sao=sao)
    use0 = ref8_2l[0] >= 0
    col_mv = torch.where(use0[..., None], mv8_2l[0], mv8_2l[1])
    col_valid = use0 | (ref8_2l[1] >= 0)
    return (packed, rec_y, rec_cb, rec_cr, col_mv[::2, ::2].contiguous(),
            col_valid[::2, ::2].contiguous(), lv_full)


def fast_i_fused_dev(src_y, src_cb, src_cr, qp: int, qp_c: int, lam: float,
                     ctb_log2: int, w: int, h: int, bit_depth: int = 8,
                     dlf: bool = True, sao: bool = True,
                     refine_modes: bool = True):
    """Device-resident I-picture pipeline: OIS -> decision -> wavefront
    closed-loop encode -> DLF -> SAO -> pack."""
    from .analysis import intra_search_size_pred
    from .intra_pass import intra_wavefront_pass

    dev = src_y.device
    yf = src_y.to(torch.float32)
    ois, preds = {}, {}
    for n in (8, 16, 32):
        with stage(f"i.intra_search_size_pred{n}"):
            mode, cost, pred = intra_search_size_pred(yf, n, bit_depth)
        ois[n] = (mode.to(torch.int32), torch.round(cost).to(torch.int32))
        preds[n] = pred
    with stage("i.decide_tree_i_dev"):
        cu_log2_8, mode8 = decide_tree_i_dev(ois, qp, ctb_log2, w, h,
                                             src=src_y.to(torch.int32),
                                             preds=preds, bit_depth=bit_depth)
    h64, w64 = src_y.shape
    zy = torch.zeros((h64, w64), dtype=torch.int32, device=dev)
    zc = torch.zeros((h64 // 2, w64 // 2), dtype=torch.int32, device=dev)
    nby, nbx = h64 // 8, w64 // 8
    with stage("i.intra_wavefront_pass"):
        (rec_y, rec_cb, rec_cr, lv_y, lv_cb, lv_cr,
         mode8) = intra_wavefront_pass(
            src_y, src_cb, src_cr, zy, zc, zc, zy, zc, zc, cu_log2_8, mode8,
            torch.ones((nby, nbx), dtype=torch.bool, device=dev), qp, qp_c,
            w=w, h=h, bit_depth=bit_depth, ctb_log2=ctb_log2, lam=lam,
            refine_modes=refine_modes)
    inter8 = torch.zeros((nby, nbx), dtype=torch.bool, device=dev)
    mv8 = torch.zeros((nby, nbx, 2), dtype=torch.int32, device=dev)
    tu8 = torch.clamp_max(cu_log2_8, 5)
    with stage("i._finish_fused"):
        packed_fin, rec_y, rec_cb, rec_cr, lv_full = _finish_fused(
            (src_y, src_cb, src_cr), (rec_y, rec_cb, rec_cr),
            (lv_y, lv_cb, lv_cr), cu_log2_8, inter8, mv8, tu8, qp, qp_c,
            lam, ctb_log2, w, h, bit_depth, dlf, sao)
    packed = torch.cat(
        [_pack([cu_log2_8, inter8, mv8, mode8, tu8], torch.int16),
         packed_fin])
    return (packed, rec_y, rec_cb, rec_cr,
            mv8[::2, ::2].contiguous(), inter8[::2, ::2].contiguous(),
            lv_full)


# ------------------------------------------- one-graph packed P / I pictures
#
# The JAX package's one-graph forms of a P and an I picture, on phase
# planes, packed for one download: fast_p_fused_packed is what
# parallel.mesh.gop_encode_step runs on every rank. They take no DLF, SAO,
# TMVP or MV rate (the encoder's fused paths, fast_p_fused_dev and
# fast_i_fused_dev, do). qp / qp_c: Python ints or 0-d integer tensors
# (read once on the host).

FUSED_EXTRA = ("cu_log2_8", "inter8", "mv8", "intra_mode8")


def _pack_fused(rec3, lv3, cu_log2_8, inter8, mv8, mode8) -> torch.Tensor:
    """The EP_KEYS planes (nz maps from the levels) and the decision maps
    in one int16 tensor (fused_specs)."""
    lv_y, lv_cb, lv_cr = lv3
    arrs = [lv_y, lv_cb, lv_cr, *rec3, _nz_map(lv_y, 4), _nz_map(lv_cb, 4),
            _nz_map(lv_cr, 4), cu_log2_8, inter8, mv8, mode8]
    return _pack(arrs, torch.int16)


def fast_p_fused_packed(src_y, src_cb, src_cr, ref_y, ref_cb, ref_cr,
                        hme_mv, qp, qp_c, ctb_log2: int, w: int, h: int,
                        bit_depth: int = 8) -> torch.Tensor:
    """One P picture as one packed tensor: reference phase planes ->
    dense inter MD + open-loop intra costs -> the SAD-form quadtree
    decision -> the phase-plane encode pass -> the closed-loop intra
    wavefront over the intra CUs (always run, at min_cu_log2 = 3) ->
    pack (fused_specs)."""
    from .analysis import intra_search_size
    from .intra_pass import intra_wavefront_pass

    qp, qp_c = int(qp), int(qp_c)
    raw_y = luma_phase_planes(ref_y, bit_depth=bit_depth)
    raw_cb = chroma_phase_planes(ref_cb, bit_depth=bit_depth)
    raw_cr = chroma_phase_planes(ref_cr, bit_depth=bit_depth)
    md = dense_md_p(src_y, ref_y, hme_mv, bit_depth=bit_depth)
    yf = src_y.to(torch.float32)
    ois = {}
    for n in (8, 16, 32):
        mode, cost = intra_search_size(yf, n)
        ois[n] = (mode.to(torch.int32), torch.round(cost).to(torch.int32))
    cu_log2_8, inter8, mv8, mode8 = decide_tree_dev(md, ois, ctb_log2,
                                                    w=w, h=h)
    out = encode_pass_p(src_y, src_cb, src_cr, raw_y, raw_cb, raw_cr, mv8,
                        inter8, torch.clamp_max(cu_log2_8, 5), qp, qp_c,
                        bit_depth=bit_depth)
    rec_y, rec_cb, rec_cr, lv_y, lv_cb, lv_cr, _ = intra_wavefront_pass(
        src_y, src_cb, src_cr, out["rec_y"], out["rec_cb"], out["rec_cr"],
        out["lv_y"], out["lv_cb"], out["lv_cr"], cu_log2_8, mode8, ~inter8,
        qp, qp_c, w=w, h=h, bit_depth=bit_depth, ctb_log2=ctb_log2)
    return _pack_fused((rec_y, rec_cb, rec_cr), (lv_y, lv_cb, lv_cr),
                       cu_log2_8, inter8, mv8, mode8)


def fused_specs(h64: int, w64: int):
    nby, nbx = h64 // 8, w64 // 8
    return ep_specs(h64, w64) + [
        ("cu_log2_8", (nby, nbx), np.int32),
        ("inter8", (nby, nbx), bool),
        ("mv8", (nby, nbx, 2), np.int32),
        ("intra_mode8", (nby, nbx), np.int32)]


def fast_i_fused_packed(src_y, src_cb, src_cr, qp, qp_c, ctb_log2: int,
                        w: int, h: int, bit_depth: int = 8) -> torch.Tensor:
    """One I picture as one packed tensor (fused_specs): open-loop intra
    search -> the true-RD intra decision -> the closed-loop wavefront
    encode -> pack. The JAX function unpacks the wavefront's seven
    outputs into six names and raises; this is the graph it describes
    (the wavefront's planes, its mode map left out)."""
    from .analysis import intra_search_size_pred
    from .intra_pass import intra_wavefront_pass

    qp, qp_c = int(qp), int(qp_c)
    dev = src_y.device
    yf = src_y.to(torch.float32)
    ois, preds = {}, {}
    for n in (8, 16, 32):
        mode, cost, pred = intra_search_size_pred(yf, n, bit_depth)
        ois[n] = (mode.to(torch.int32), torch.round(cost).to(torch.int32))
        preds[n] = pred
    cu_log2_8, mode8 = decide_tree_i_dev(ois, qp, ctb_log2, w, h,
                                         src=src_y.to(torch.int32),
                                         preds=preds, bit_depth=bit_depth)
    h64, w64 = src_y.shape
    zy = torch.zeros((h64, w64), dtype=torch.int32, device=dev)
    zc = torch.zeros((h64 // 2, w64 // 2), dtype=torch.int32, device=dev)
    nby, nbx = h64 // 8, w64 // 8
    rec_y, rec_cb, rec_cr, lv_y, lv_cb, lv_cr, _ = intra_wavefront_pass(
        src_y, src_cb, src_cr, zy, zc, zc, zy, zc, zc, cu_log2_8, mode8,
        torch.ones((nby, nbx), dtype=torch.bool, device=dev), qp, qp_c,
        w=w, h=h, bit_depth=bit_depth, ctb_log2=ctb_log2)
    return _pack_fused(
        (rec_y, rec_cb, rec_cr), (lv_y, lv_cb, lv_cr), cu_log2_8,
        torch.zeros((nby, nbx), dtype=torch.bool, device=dev),
        torch.zeros((nby, nbx, 2), dtype=torch.int32, device=dev), mode8)


# ----------------------------------------------------------------- SAO stats

_EO_CAT = (1, 2, 0, 3, 4)


@functools.lru_cache(maxsize=None)
def eo_cat_lut(device: str) -> torch.Tensor:
    """SAO edge-offset category of 2 + sign + sign (8.7.3), on a device."""
    return torch.tensor(_EO_CAT, dtype=torch.int64, device=device)


def sao_stats_plane(pre: torch.Tensor, src: torch.Tensor,
                    valid: torch.Tensor, ctb_y: int, ctb_x: int,
                    bit_depth: int = 8) -> dict:
    """Per-CTB SAO statistics for one plane: eo_cnt/eo_sum (ny, nx, 4, 5)
    and bo_cnt/bo_sum (ny, nx, 32) int32. The JAX graph sums in float32
    below 2^24, i.e. exactly; the port sums the same integers in int64."""
    h, w = pre.shape
    ny, nx = h // ctb_y, w // ctb_x
    dev = pre.device
    ok_v = valid > 0
    diff = torch.where(ok_v, src.to(torch.int64) - pre.to(torch.int64), 0)

    def ctb_sum(m):
        return m.to(torch.int64).reshape(ny, ctb_y, nx, ctb_x).sum((1, 3))

    p = pre.to(torch.int32)
    pad = _edge_pad(p, 1)
    lut = eo_cat_lut(str(dev))
    neigh = (((-1, 0), (1, 0)), ((0, -1), (0, 1)),
             ((-1, -1), (1, 1)), ((1, -1), (-1, 1)))
    eo_cnt, eo_sum = [], []
    for (ax, ay), (bx, by) in neigh:
        na = pad[1 + ay:h + 1 + ay, 1 + ax:w + 1 + ax]
        nb = pad[1 + by:h + 1 + by, 1 + bx:w + 1 + bx]
        edge = 2 + torch.sign(p - na) + torch.sign(p - nb)
        cat = lut[edge.long()]
        border = torch.zeros((h, w), dtype=torch.bool, device=dev)
        if ax != 0 or bx != 0:
            border[:, 0] = True
            border[:, w - 1] = True
        if ay != 0 or by != 0:
            border[0, :] = True
            border[h - 1, :] = True
        ok = ok_v & ~border
        cnts, sums = [], []
        for k in range(5):
            m = (cat == k) & ok
            cnts.append(ctb_sum(m))
            sums.append(ctb_sum(diff * m))
        eo_cnt.append(torch.stack(cnts, -1))
        eo_sum.append(torch.stack(sums, -1))

    band = p >> (bit_depth - 5)
    bo_cnt, bo_sum = [], []
    for b in range(32):
        m = (band == b) & ok_v
        bo_cnt.append(ctb_sum(m))
        bo_sum.append(ctb_sum(diff * m))
    return {
        "eo_cnt": torch.stack(eo_cnt, -2).to(torch.int32),
        "eo_sum": torch.stack(eo_sum, -2).to(torch.int32),
        "bo_cnt": torch.stack(bo_cnt, -1).to(torch.int32),
        "bo_sum": torch.stack(bo_sum, -1).to(torch.int32),
    }
