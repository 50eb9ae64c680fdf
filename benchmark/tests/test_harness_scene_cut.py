"""No IDR lands in a window: the encoder's scene-cut detector fires on no
frame of either mix, at the cells' size, over more frames than a window
pulls and for a dozen seeds."""

import pytest

from frames import Source, load_mix

SEEDS = [7, 11, 2 ** 31 + 1, 2 ** 31 + 7] + list(range(900, 908))
# frames a window pulls, with room: ldp_1080p_m7_qp32.pan yields about
# 4 a second for 40 s; vbr10_1080p_m8.reveal under 1 a second, with a
# lookahead that pulls 36 frames ahead
FRAMES = {"pan": (8, 240), "reveal": (10, 120)}


@pytest.mark.parametrize("mix", sorted(FRAMES))
@pytest.mark.parametrize("seed", SEEDS)
def test_scene_cut_never_fires(mix, seed):
    from svt_hevc_tpu_torch.pipeline.encoder import Encoder
    bits, n = FRAMES[mix]
    src = Source(load_mix(mix), 1920, 1080, bits, seed)
    prev = src.frame(0)[0]
    for i in range(1, n):
        cur = src.frame(i)[0]
        assert not Encoder._scene_cut(prev, cur), (mix, seed, i)
        prev = cur
