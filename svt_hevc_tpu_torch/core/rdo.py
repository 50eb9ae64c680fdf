"""Rate-distortion mode decision over the CU quadtree.

Recursive compress: for each CU position, trial-encode the "leaf" option
(and NxN at min size) and the "split" option through the *real* CtuEncoder
walk — writing into a CabacEstimator instead of the arithmetic coder — and
keep the cheaper one by J = SSD + lambda * bits. Trials reconstruct into
the live PictureState with save/restore of the affected region, so every
trial sees exactly the references the decoder will see.

Because the encode pass is decoder-shaped (core/ctu.py), the trial and the
final emission produce identical reconstructions; the final CABAC walk just
replays the winning decisions.

Analogue of reference Source/Lib/Codec/EbProductCodingLoop.c
(ModeDecisionLcu :4691: fast loop -> full loop over the 85-CU tree) with
densified recursion instead of MD-scan staging; lambda model follows the
HM/reference I-slice SSE lambda (EbLambdaRateTables.h semantics).
"""

from __future__ import annotations

import numpy as np

from ..bitstream.contexts import Ctx
from ..bitstream.estimator import CabacEstimator
from .ctu import CtuEncoder, PictureState, split_cu_ctx


def lambda_sse(qp: int) -> float:
    """HM-style I-slice SSE lambda."""
    return 0.57 * 2.0 ** ((qp - 12) / 3.0)


class _Region:
    """Snapshot of all mutable picture state covering one luma rect."""

    __slots__ = ("x0", "y0", "n", "planes", "avail", "mode", "depth",
                 "edge_v", "edge_h", "mv", "ref", "skip", "cbf4", "qg")

    def __init__(self, st: PictureState, x0: int, y0: int, n: int):
        self.x0, self.y0, self.n = x0, y0, n
        xc, yc = x0 >> st.ss_x, y0 >> st.ss_y
        ncx, ncy = n >> st.ss_x, n >> st.ss_y
        self.planes = (
            st.planes[0][y0:y0 + n, x0:x0 + n].copy(),
            st.planes[1][yc:yc + ncy, xc:xc + ncx].copy(),
            st.planes[2][yc:yc + ncy, xc:xc + ncx].copy(),
        )
        self.avail = (
            st.avail[0][y0 >> 2:(y0 + n) >> 2, x0 >> 2:(x0 + n) >> 2].copy(),
            st.avail[1][yc >> 2:(yc + ncy) >> 2, xc >> 2:(xc + ncx) >> 2].copy(),
            st.avail[2][yc >> 2:(yc + ncy) >> 2, xc >> 2:(xc + ncx) >> 2].copy(),
        )
        self.mode = st.luma_mode[y0 >> 2:(y0 + n) >> 2, x0 >> 2:(x0 + n) >> 2].copy()
        self.depth = st.cqt_depth[y0 >> 2:(y0 + n) >> 2, x0 >> 2:(x0 + n) >> 2].copy()
        self.edge_v = st.edge_v[y0 >> 2:(y0 + n) >> 2, x0 >> 3:(x0 + n) >> 3].copy()
        self.edge_h = st.edge_h[y0 >> 3:(y0 + n) >> 3, x0 >> 2:(x0 + n) >> 2].copy()
        ys, xs = slice(y0 >> 2, (y0 + n) >> 2), slice(x0 >> 2, (x0 + n) >> 2)
        self.mv = st.mv[ys, xs].copy()
        self.ref = st.ref_idx[ys, xs].copy()
        self.skip = st.skip[ys, xs].copy()
        self.cbf4 = st.cbf4[ys, xs].copy()
        # quantization-group scalars (cu_qp_delta emission state)
        self.qg = (st.qp, st.qp_c, st.qg_qp_coded)

    def restore(self, st: PictureState) -> None:
        x0, y0, n = self.x0, self.y0, self.n
        xc, yc = x0 >> st.ss_x, y0 >> st.ss_y
        ncx, ncy = n >> st.ss_x, n >> st.ss_y
        st.planes[0][y0:y0 + n, x0:x0 + n] = self.planes[0]
        st.planes[1][yc:yc + ncy, xc:xc + ncx] = self.planes[1]
        st.planes[2][yc:yc + ncy, xc:xc + ncx] = self.planes[2]
        st.avail[0][y0 >> 2:(y0 + n) >> 2, x0 >> 2:(x0 + n) >> 2] = self.avail[0]
        st.avail[1][yc >> 2:(yc + ncy) >> 2, xc >> 2:(xc + ncx) >> 2] = self.avail[1]
        st.avail[2][yc >> 2:(yc + ncy) >> 2, xc >> 2:(xc + ncx) >> 2] = self.avail[2]
        st.luma_mode[y0 >> 2:(y0 + n) >> 2, x0 >> 2:(x0 + n) >> 2] = self.mode
        st.cqt_depth[y0 >> 2:(y0 + n) >> 2, x0 >> 2:(x0 + n) >> 2] = self.depth
        st.edge_v[y0 >> 2:(y0 + n) >> 2, x0 >> 3:(x0 + n) >> 3] = self.edge_v
        st.edge_h[y0 >> 3:(y0 + n) >> 3, x0 >> 2:(x0 + n) >> 2] = self.edge_h
        ys, xs = slice(y0 >> 2, (y0 + n) >> 2), slice(x0 >> 2, (x0 + n) >> 2)
        st.mv[ys, xs] = self.mv
        st.ref_idx[ys, xs] = self.ref
        st.skip[ys, xs] = self.skip
        st.cbf4[ys, xs] = self.cbf4
        st.qp, st.qp_c, st.qg_qp_coded = self.qg


class Decisions:
    """Winning CU tree of one CTB, consumed by the final CABAC walk."""

    def __init__(self) -> None:
        self.leaves: dict[tuple[int, int, int], bool] = {}  # (x,y,log2)->nxn
        self.pu_modes: dict[tuple[int, int], int] = {}      # (px,py)->mode

    # policies for CtuEncoder
    def split_policy(self, x0, y0, log2, depth) -> bool:
        return (x0, y0, log2) not in self.leaves

    def part_nxn_policy(self, x0, y0) -> bool:
        return self.leaves.get((x0, y0, 3), False)

    def mode_policy(self, px, py, n):
        return self.pu_modes.get((px, py))


class RdSearch:
    """Per-CTB RD search. mode_candidates optionally restricts the luma
    mode loop (e.g. from the TPU open-loop search)."""

    def __init__(self, st: PictureState, src, *, lam: float | None = None,
                 mode_candidates=None, try_nxn: bool = True, me_seed=None,
                 features=None, ois=None, mcts_rect=None):
        self.st = st
        self.src = src
        self._lam_auto = lam is None
        self.lam = lambda_sse(st.qp) if lam is None else lam
        self.mode_candidates = mode_candidates
        self.try_nxn = try_nxn
        self.me_seed = me_seed
        self.features = features
        self.ois = ois
        self.mcts_rect = mcts_rect

    # ------------------------------------------------------------------ api
    def compress_ctu(self, x0: int, y0: int, ctx: list[int]) -> tuple[Decisions, list[int]]:
        """RD-search one CTB. On return the PictureState holds the winning
        reconstruction, and `ctx` is NOT consumed (callers re-walk with the
        real coder). Returns (decisions, estimator ctx after the CTB)."""
        st = self.st
        st.qg_begin(x0 >> st.ctb_log2, y0 >> st.ctb_log2)
        if self._lam_auto:
            self.lam = lambda_sse(st.qp)     # per-CTB lambda under QPM
        dec = Decisions()
        _, ctx_out = self._compress(x0, y0, st.ctb_log2, 0, ctx, dec)
        st.qg_end(x0 >> st.ctb_log2, y0 >> st.ctb_log2)
        return dec, ctx_out

    # ------------------------------------------------------------- recursion
    def _ssd(self, x0: int, y0: int, n: int) -> float:
        st, src = self.st, self.src
        xc, yc = x0 >> st.ss_x, y0 >> st.ss_y
        ncx, ncy = n >> st.ss_x, n >> st.ss_y
        d = 0.0
        for c_idx, (px, py, pw, ph) in (
                (0, (x0, y0, n, n)), (1, (xc, yc, ncx, ncy)),
                (2, (xc, yc, ncx, ncy))):
            a = st.planes[c_idx][py:py + ph, px:px + pw].astype(np.int64)
            b = src[c_idx][py:py + ph, px:px + pw].astype(np.int64)
            d += float(((a - b) ** 2).sum())
        return d

    def _leaf_trial(self, x0, y0, log2, depth, ctx, nxn: bool):
        """Encode the CU as a leaf into an estimator; returns
        (cost, ctx_after, region_after, pu_modes)."""
        est = CabacEstimator(list(ctx))
        enc = CtuEncoder(self.st, est, self.src,
                         split_policy=lambda *a: False,
                         part_nxn_policy=lambda *a: nxn,
                         mode_policy=self.mode_candidates,
                         me_seed=self.me_seed, features=self.features,
                         ois=self.ois, mcts_rect=self.mcts_rect)
        if log2 > 3:
            est.encode_bin(Ctx.SPLIT_CU + split_cu_ctx(self.st, x0, y0, depth), 0)
        enc.coding_unit(x0, y0, log2, depth)
        n = 1 << log2
        cost = self._ssd(x0, y0, n) + self.lam * est.bits
        modes = {}
        for py in range(y0, y0 + n, 4):
            for px in range(x0, x0 + n, 4):
                modes[(px, py)] = int(self.st.luma_mode[py >> 2, px >> 2])
        return cost, est.ctx, _Region(self.st, x0, y0, n), modes

    def _compress(self, x0, y0, log2, depth, ctx, dec: Decisions):
        st = self.st
        n = 1 << log2
        inside = x0 + n <= st.w and y0 + n <= st.h
        pre = _Region(st, x0, y0, n)

        best = None    # (cost, ctx, region, leaves-patch, modes-patch)
        if inside:
            trials = [(False,)] + ([(True,)] if (log2 == 3 and self.try_nxn) else [])
            for (nxn,) in trials:
                cost, tctx, region, modes = self._leaf_trial(
                    x0, y0, log2, depth, ctx, nxn)
                if best is None or cost < best[0]:
                    best = (cost, tctx, region, {(x0, y0, log2): nxn}, modes)
                pre.restore(st)

        if log2 > 3 or not inside:
            est_ctx = list(ctx)
            split_bits = 0.0
            if inside:
                e = CabacEstimator(est_ctx)
                e.encode_bin(Ctx.SPLIT_CU + split_cu_ctx(st, x0, y0, depth), 1)
                est_ctx = e.ctx
                split_bits = e.bits
            half = n >> 1
            child_cost = 0.0
            leaves_patch: dict = {}
            modes_patch: dict = {}
            sub = Decisions()
            ok = True
            for dx, dy in ((0, 0), (half, 0), (0, half), (half, half)):
                x1, y1 = x0 + dx, y0 + dy
                if x1 >= st.w or y1 >= st.h:
                    continue
                if log2 - 1 < 3:
                    ok = False
                    break
                (c, est_ctx) = self._compress(x1, y1, log2 - 1, depth + 1,
                                              est_ctx, sub)
                child_cost += c
            if ok:
                split_cost = child_cost + self.lam * split_bits
                if best is None or split_cost < best[0]:
                    # children already applied their winning recon + filled
                    # `sub`; region state is current
                    dec.leaves.update(sub.leaves)
                    dec.pu_modes.update(sub.pu_modes)
                    return split_cost, est_ctx
                # split lost: restore pre-state then re-apply leaf winner
                pre.restore(st)

        assert best is not None
        cost, tctx, region, leaves_patch, modes_patch = best
        region.restore(st)        # apply winning leaf reconstruction
        dec.leaves.update(leaves_patch)
        dec.pu_modes.update(modes_patch)
        return cost, tctx
