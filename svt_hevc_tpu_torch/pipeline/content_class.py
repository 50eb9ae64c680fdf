"""Content classification driving QP/MD adaptation.

TPU-native analogue of the reference's SourceBasedOperations process
(EbSourceBasedOperationsProcess.c DerivePictureActivityStatistics :81,
grass/skin/dark/aura LCU classification :1159-1369): the reference walks
LCUs accumulating per-class percentages from pixel/chroma statistics;
here every class is a dense vectorized map over the CTB grid computed
from plane statistics the pipeline already has on host (means come from
the padded source planes; activity from tpu.analysis.ctb_activity).

Classes (all per-CTB bool/fraction maps):
  - grass: vegetation texture — mid luma with green-deficient chroma
    (Cb well below neutral, Cr near neutral). The reference protects
    grass with lower QP because quantized grass 'boils' visibly.
  - skin: face/skin tones — Cr moderately above neutral, Cb slightly
    below, mid-high luma. Protected for the same perceptual reason.
  - dark: low mean luma (banding visibility; reference dark-area class).
  - high_texture: activity above ~4x the picture geometric mean (strong
    masking — safe to raise QP).
  - stationary_edge: low temporal difference but high spatial gradient
    (reference stationary-edge-over-time flags,
    EbSourceBasedOperationsProcess.c / EbMotionEstimationProcess.c
    :799-817): edges that persist across frames attract the eye, so
    they are protected from QP increase.

The classifier is intentionally simple, integer-friendly and fully
vectorized; class maps feed _derive_qp_map (QPM) exactly like the
reference's classes feed QpmDeriveWeightsMinAndMax
(EbEncDecProcess.c :1919).
"""

from __future__ import annotations

import numpy as np


def _ctb_mean(plane: np.ndarray, ctb: int) -> np.ndarray:
    h, w = plane.shape
    hh, ww = h // ctb * ctb, w // ctb * ctb
    p = plane[:hh, :ww]
    return p.reshape(hh // ctb, ctb, ww // ctb, ctb).mean((1, 3))


def classify_ctbs(y: np.ndarray, cb: np.ndarray, cr: np.ndarray,
                  ctb: int, activity: np.ndarray | None = None,
                  prev_y: np.ndarray | None = None,
                  bit_depth: int = 8) -> dict:
    """Per-CTB content class maps from padded source planes.

    y: (H, W); cb/cr: chroma planes at any subsampling (means are taken
    over the co-located chroma CTB); activity: optional per-CTB spatial
    activity (variance-like, from tpu.analysis.ctb_activity);
    prev_y: previous source luma for the temporal (stationary) axis.
    Returns dict of (nCTBy, nCTBx) arrays: grass, skin, dark,
    high_texture, stationary_edge (bool) + pct_* scalars (fractions).
    """
    shift = bit_depth - 8
    neutral = 128 << shift
    ym = _ctb_mean(y.astype(np.float32), ctb)
    cy = ctb * cb.shape[0] // y.shape[0]
    cx = ctb * cb.shape[1] // y.shape[1]
    cbm = _ctb_mean(cb.astype(np.float32), max(cy, 1))
    crm = _ctb_mean(cr.astype(np.float32), max(cx, 1))
    gy, gx = ym.shape
    cbm = cbm[:gy, :gx]
    crm = crm[:gy, :gx]

    lum_mid = (ym > (40 << shift)) & (ym < (180 << shift))
    grass = (lum_mid
             & (cbm < neutral - (8 << shift))
             & (np.abs(crm - neutral) < (12 << shift)))
    skin = ((ym > (60 << shift)) & (ym < (220 << shift))
            & (crm > neutral + (6 << shift))
            & (crm < neutral + (36 << shift))
            & (cbm > neutral - (30 << shift))
            & (cbm < neutral + (4 << shift)))
    dark = ym < 0.2 * (1 << bit_depth)

    if activity is not None:
        act = np.maximum(np.asarray(activity, np.float64)[:gy, :gx], 1.0)
        gmean = float(np.exp(np.log(act).mean()))
        high_texture = act > 4.0 * gmean
    else:
        high_texture = np.zeros_like(grass)

    if prev_y is not None and prev_y.shape == y.shape:
        hh, ww = gy * ctb, gx * ctb
        cur = y[:hh, :ww].astype(np.int32)
        prv = prev_y[:hh, :ww].astype(np.int32)
        tdiff = _ctb_mean(np.abs(cur - prv).astype(np.float32), ctb)
        gxv = np.abs(np.diff(cur.astype(np.float32), axis=1))
        gyv = np.abs(np.diff(cur.astype(np.float32), axis=0))
        g = (np.pad(gxv, ((0, 0), (0, 1)), mode="edge")
             + np.pad(gyv, ((0, 1), (0, 0)), mode="edge"))
        # a mean |gradient| dilutes thin edges (one 140-step edge column
        # averages to ~2 over a 64-wide CTB): classify by the FRACTION
        # of strong-edge pixels instead (the reference's edge detection
        # is likewise a thresholded pixel count,
        # EbPictureAnalysisProcess.c:3627)
        edge_frac = _ctb_mean((g > (32 << shift)).astype(np.float32), ctb)
        stationary_edge = (tdiff < (2 << shift)) & (edge_frac > 0.01)
    else:
        stationary_edge = np.zeros_like(grass)

    n = float(grass.size)
    return {
        "grass": grass, "skin": skin, "dark": dark,
        "high_texture": high_texture, "stationary_edge": stationary_edge,
        "pct_grass": float(grass.sum()) / n,
        "pct_skin": float(skin.sum()) / n,
        "pct_dark": float(dark.sum()) / n,
    }


def qp_class_delta(classes: dict) -> np.ndarray:
    """Per-CTB QP delta from the class maps (the QPM consumption,
    reference: QpmDeriveWeightsMinAndMax EbEncDecProcess.c :1919 driven
    by the SourceBasedOperations classes): protect grass/skin/dark/
    stationary edges, spend less on strongly-masked texture."""
    d = np.zeros(classes["grass"].shape, np.int32)
    d = np.where(classes["high_texture"], d + 1, d)
    d = np.where(classes["grass"] | classes["skin"], d - 1, d)
    d = np.where(classes["dark"], d - 1, d)
    d = np.where(classes["stationary_edge"], np.minimum(d, 0) - 1, d)
    return np.clip(d, -2, 2)
