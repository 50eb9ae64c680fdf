"""HEVC level/tier derivation and enforcement.

The analogue of the reference's level handling: per-level tile caps
(reference: maxTileColumnCount/maxTileRowCount tables, EbEncHandle.c:69-76)
and the level/tier checks inside VerifySettings (EbEncHandle.c:2134).
Limits are the public HEVC spec tables A.6 (picture size / sample rate /
tiles) and A.8 (max bit rate per tier).
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class LevelLimits:
    idc: int            # general_level_idc = 30 * level number
    name: str
    max_luma_ps: int    # max luma picture size (samples)
    max_luma_sr: int    # max luma sample rate (samples/s)
    max_tile_cols: int
    max_tile_rows: int
    max_br_main: int    # max bit rate, Main tier (bits/s)
    max_br_high: int    # Max bit rate, High tier (0 = no High tier)


# H.265 Tables A.6/A.8 (CpbBrVclFactor-scaled rates omitted; NAL factor
# 1100/1000 is absorbed by using the kbit numbers x1000 like the reference).
LEVELS = (
    LevelLimits(30, "1",    36864,     552960,     1,  1,  128000,     0),
    LevelLimits(60, "2",    122880,    3686400,    1,  1,  1500000,    0),
    LevelLimits(63, "2.1",  245760,    7372800,    1,  1,  3000000,    0),
    LevelLimits(90, "3",    552960,    16588800,   2,  2,  6000000,    0),
    LevelLimits(93, "3.1",  983040,    33177600,   3,  3,  10000000,   0),
    LevelLimits(120, "4",   2228224,   66846720,   5,  5,  12000000,
                30000000),
    LevelLimits(123, "4.1", 2228224,   133693440,  5,  5,  20000000,
                50000000),
    LevelLimits(150, "5",   8912896,   267386880,  10, 11, 25000000,
                100000000),
    LevelLimits(153, "5.1", 8912896,   534773760,  10, 11, 40000000,
                160000000),
    LevelLimits(156, "5.2", 8912896,   1069547520, 10, 11, 60000000,
                240000000),
    LevelLimits(180, "6",   35651584,  1069547520, 20, 22, 60000000,
                240000000),
    LevelLimits(183, "6.1", 35651584,  2139095040, 20, 22, 120000000,
                480000000),
    LevelLimits(186, "6.2", 35651584,  4278190080, 20, 22, 240000000,
                800000000),
)

_BY_NAME = {lv.name: lv for lv in LEVELS}


def derive_level(cfg) -> tuple[LevelLimits, bool]:
    """Pick the smallest (level, tier) admitting the configured stream:
    returns (limits, high_tier). Raises if even 6.2 High cannot hold it
    (the reference fails VerifySettings the same way)."""
    luma_ps = cfg.coded_width * cfg.coded_height
    fps = cfg.fps_num / max(cfg.fps_den, 1)
    luma_sr = luma_ps * fps
    bitrate = max(cfg.target_bitrate, cfg.vbv_maxrate)
    for lv in LEVELS:
        if luma_ps > lv.max_luma_ps or luma_sr > lv.max_luma_sr:
            continue
        if cfg.tile_columns > lv.max_tile_cols:
            continue
        if cfg.tile_rows > lv.max_tile_rows:
            continue
        if bitrate <= lv.max_br_main:
            return lv, False
        if bitrate <= lv.max_br_high:
            return lv, True
    raise ValueError(
        f"stream exceeds HEVC level 6.2 limits: {luma_ps} luma samples, "
        f"{luma_sr:.0f} samples/s, {cfg.tile_columns}x{cfg.tile_rows} tiles, "
        f"{bitrate} bits/s")


def level_by_name(name: str) -> LevelLimits:
    return _BY_NAME[name]
