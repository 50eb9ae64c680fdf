"""The check of the encoder's decisions: what the stream spends and what
it gives back.

Any decisions make a valid stream, so the decoder alone cannot see a
worse motion search, a coarser mode decision or a cheaper residual
coding. What a user sees of them is the rate and the quality. Over a
fixed range of display indices (the same pictures in every run of a
cell, whatever the window's length, since quality drifts along a
low-delay stream), the stream's bytes and the mean luma PSNR of its
reconstruction against the source give one number: the bytes that would
have reached the expected PSNR, at DB_PER_DOUBLING dB for each doubling
of the rate, over the expected bytes, less one, in percent. Positive is
worse than expected. Imports numpy only.
"""

from __future__ import annotations

import math

import numpy as np

# HEVC's rate-distortion curves under the common test conditions gain
# about 2.5 dB of luma PSNR for each doubling of the rate between QP 22
# and 37; the weight of a PSNR change against a rate change.
DB_PER_DOUBLING = 2.5


def psnr(rec, src, bit_depth: int) -> float:
    """Luma PSNR in dB of one reconstructed plane against its source."""
    d = np.asarray(rec, np.float64) - np.asarray(src, np.float64)
    mse = float(np.mean(d * d))
    peak = float((1 << bit_depth) - 1)
    return 10.0 * math.log10(peak * peak / mse) if mse else math.inf


def rate_loss_pct(nbytes: int, psnr_db: float, expect: dict) -> float:
    """The rate that would have given expect["psnr_y_db"], over
    expect["bytes"], less one, in percent."""
    rate = nbytes * 2.0 ** ((expect["psnr_y_db"] - psnr_db)
                            / DB_PER_DOUBLING)
    return 100.0 * (rate / expect["bytes"] - 1.0)


def quality(pictures: dict, source_luma, bit_depth: int,
            quality_spec: dict) -> dict:
    """bytes, psnr_y_db and rate_loss_pct over the spec's range of
    display indices. pictures: {display index: {data, planes}};
    source_luma(i): the source's luma of picture i."""
    first, count = quality_spec["first"], quality_spec["count"]
    idx = range(first, first + count)
    missing = [i for i in idx if i not in pictures]
    if missing:
        raise ValueError(f"pictures {missing[:4]} of the quality range "
                         f"were not coded")
    nbytes = sum(len(pictures[i]["data"]) for i in idx)
    db = float(np.mean([psnr(pictures[i]["planes"][0], source_luma(i),
                             bit_depth) for i in idx]))
    return {"bytes": nbytes, "psnr_y_db": db,
            "rate_loss_pct": rate_loss_pct(nbytes, db,
                                           quality_spec["expect"])}
