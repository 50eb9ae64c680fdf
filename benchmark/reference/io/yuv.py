"""The decoded frame: three planes."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class Frame:
    """One planar YUV frame. y: (H, W); cb/cr: (H/2, W/2) for 4:2:0,
    (H, W/2) for 4:2:2, (H, W) for 4:4:4."""
    y: np.ndarray
    cb: np.ndarray
    cr: np.ndarray
    # optional per-picture metadata (reference: per-input-buffer SEI/RPU
    # attachments, EbApi.h EB_SEI_MESSAGE dolbyVisionRpu / user data)
    dv_rpu: bytes | None = None        # Dolby Vision RPU (emitted as NAL 62)
    sei_t35: bytes | None = None       # registered user data (ITU-T T.35)
    sei_unreg: tuple | None = None     # (uuid16: bytes, data: bytes)
    segment_ov: np.ndarray | None = None
                                       # (n_ctb_y, n_ctb_x, 3) per-CTB
                                       # [flags, qp_ov, deblock_ov] override
                                       # (reference SegmentOverride_t,
                                       # EbApi.h:44-68)

    @property
    def width(self) -> int:
        return self.y.shape[1]

    @property
    def height(self) -> int:
        return self.y.shape[0]

    @property
    def peak(self) -> float:
        return 255.0 if self.y.dtype == np.uint8 else 1023.0

    def psnr(self, other: "Frame") -> tuple[float, float, float]:
        out = []
        for a, b in ((self.y, other.y), (self.cb, other.cb), (self.cr, other.cr)):
            mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
            out.append(99.0 if mse == 0 else 10.0 * np.log10(self.peak ** 2 / mse))
        return tuple(out)  # type: ignore[return-value]


