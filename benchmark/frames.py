"""The benchmark's one traffic generator: synthetic video from a mix's
parameters (benchmark/traffic/<mix>.json) and a seed.

Every frame is a function of (mix, width, height, bit depth, seed, index),
made when the encoder pulls it, so a window may pull as many as it needs.
The content is bench.py's: a smoothed random luma and chroma texture,
panned by (pan.dx, pan.dy) samples a picture and wrapped every pan.wrap
pictures, with a flat square object moving by (object.dx, object.dy).
Where the mix has "reveal", every reveal.every-th picture (from
reveal.phase) gets smooth ramps at seeded places that no reference holds,
reveal.per_256x256 of them for each whole 256x256 of the picture. Where the
configuration codes more than 8 bits, the 8-bit samples are shifted up and
seeded noise fills the new low bits (deep.noise_bits of them).

Seed 7 of mix "pan" gives tools/torch_bench.make_frames(seed=7); mix
"reveal" at 10 bits gives chip_smoke.make_frames(seed=7, patches=True,
bit_depth=10). Imports numpy only.
"""

from __future__ import annotations

import json
import os

import numpy as np

TRAFFIC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "traffic")


def load_mix(name: str) -> dict:
    with open(os.path.join(TRAFFIC, f"{name}.json")) as f:
        return json.load(f)


def _texture(rng, h: int, w: int, passes: int, gain: float,
             offset: float) -> np.ndarray:
    big = rng.integers(0, 256, (h, w)).astype(np.float32)
    for _ in range(passes):
        big = (big + np.roll(big, 1, 0) + np.roll(big, 1, 1)
               + np.roll(big, -1, 0) + np.roll(big, -1, 1)) / 5.0
    return big * gain + offset


class Source:
    """Frames of one mix at w x h and bit_depth from seed: frame(i) gives
    (y, cb, cr) 4:2:0 planes, uint8 at 8 bits, else uint16."""

    def __init__(self, mix: dict, w: int, h: int, bit_depth: int,
                 seed: int):
        self.mix, self.w, self.h = mix, w, h
        self.bit_depth = bit_depth
        self.seed = int(seed) % (1 << 64)
        tex = mix["texture"]
        m = tex["margin"]
        rng = np.random.default_rng(self.seed)
        self.big = _texture(rng, h + m, w + m, tex["passes"],
                            tex["luma_gain"], tex["luma_offset"])
        self.cbig = _texture(rng, h // 2 + m // 2, w // 2 + m // 2,
                             tex["passes"], tex["chroma_gain"],
                             tex["chroma_offset"])

    def frame(self, i: int):
        w, h, mix = self.w, self.h, self.mix
        pan, obj = mix["pan"], mix["object"]
        ox, oy = (pan["dx"] * i) % pan["wrap"], (pan["dy"] * i) % pan["wrap"]
        y = self.big[oy:oy + h, ox:ox + w].astype(np.uint8).copy()
        sx = (obj["x0"] + obj["dx"] * i) % (w - obj["margin"])
        sy = (obj["y0"] + obj["dy"] * i) % (h - obj["margin"])
        n = obj["size"]
        y[sy:sy + n, sx:sx + n] = obj["luma"]
        cwin = self.cbig[oy // 2:oy // 2 + h // 2, ox // 2:ox // 2 + w // 2]
        cb = cwin.astype(np.uint8).copy()
        cr = (255 - cwin).astype(np.uint8).copy()
        cb[sy // 2:sy // 2 + n // 2, sx // 2:sx // 2 + n // 2] = obj["cb"]
        rev = mix.get("reveal")
        if rev and i % rev["every"] == rev["phase"]:
            self._reveal(y, i, rev)
        if self.bit_depth > 8:
            shift = self.bit_depth - 8
            nrng = np.random.default_rng(self.seed * 1000 + 500 + i)
            y, cb, cr = (p.astype(np.uint16) * (1 << shift)
                         + nrng.integers(0, 1 << mix["deep"]["noise_bits"],
                                         p.shape).astype(np.uint16)
                         for p in (y, cb, cr))
        return y, cb, cr

    def _reveal(self, y: np.ndarray, i: int, rev: dict) -> None:
        w, h, n = self.w, self.h, rev["size"]
        prng = np.random.default_rng(self.seed * 1000 + i)
        a = np.arange(n)
        count = max(1, rev["per_256x256"] * (w // 256) * (h // 256))
        for _ in range(count):
            py = int(prng.integers(0, h - n))
            px = int(prng.integers(0, w - n))
            sy, sx = prng.integers(rev["slope_min"], rev["slope_max"] + 1, 2)
            ramp = np.clip(rev["base"] + np.add.outer(sy * a, sx * a), 0,
                           255)
            if prng.integers(0, 2):
                ramp = ramp[::-1]
            if prng.integers(0, 2):
                ramp = ramp[:, ::-1]
            y[py:py + n, px:px + n] = ramp
