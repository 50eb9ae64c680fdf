"""The traffic generator: seeded, deterministic, and at seed 7 the frames
it copies."""

import importlib.util
import os

import numpy as np
import pytest

from conftest import ROOT
from frames import Source, load_mix

PLANES = ("y", "cb", "cr")


def test_pan_seed7_is_torch_bench_make_frames():
    spec = importlib.util.spec_from_file_location(     # tools/: no package
        "torch_bench", os.path.join(ROOT, "tools", "torch_bench.py"))
    bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench)
    ref = bench.make_frames(70, 512, 256, seed=7)
    src = Source(load_mix("pan"), 512, 256, 8, 7)
    for i, f in enumerate(ref):        # past the 64-picture wrap
        for got, name in zip(src.frame(i), PLANES):
            want = getattr(f, name)
            assert got.dtype == want.dtype and np.array_equal(got, want), \
                (i, name)


def test_reveal_seed7_is_chip_smoke_cli_clip():
    import chip_smoke
    ref = chip_smoke.make_frames(6, 512, 256, seed=7, patches=True,
                                 bit_depth=10)
    src = Source(load_mix("reveal"), 512, 256, 10, 7)
    for i, f in enumerate(ref):
        for got, name in zip(src.frame(i), PLANES):
            want = getattr(f, name)
            assert got.dtype == want.dtype and np.array_equal(got, want), \
                (i, name)


@pytest.mark.parametrize("mix,bits", [("pan", 8), ("reveal", 10)])
def test_same_seed_same_frames_other_seed_other_frames(mix, bits):
    seed = 2 ** 31 + 99          # the driver's seeds pass 32 bits
    a = Source(load_mix(mix), 320, 256, bits, seed)
    b = Source(load_mix(mix), 320, 256, bits, seed)
    c = Source(load_mix(mix), 320, 256, bits, seed + 1)
    for i in (0, 1, 5, 130):
        for pa, pb, pc in zip(a.frame(i), b.frame(i), c.frame(i)):
            assert np.array_equal(pa, pb)
            assert not np.array_equal(pa, pc)


def test_reveal_puts_ramps_on_odd_pictures_only():
    pan = Source(load_mix("pan"), 512, 512, 8, 5)
    rev = Source(load_mix("reveal"), 512, 512, 8, 5)
    assert np.array_equal(pan.frame(4)[0], rev.frame(4)[0])
    diff = pan.frame(5)[0] != rev.frame(5)[0]
    assert 0 < diff.sum() <= 4 * 64 * 64       # (512 // 256) ** 2 ramps
