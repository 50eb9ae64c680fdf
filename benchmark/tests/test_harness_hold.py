"""The bound on frames the program holds, pulled and not yet yielded: a
program that reads its feed to the end before it yields is stopped after
HOLD_MAX + 1 pulls, with nothing measured or checked; a streaming one
holds a few, and every run logs the most it held.

    python3 -m pytest benchmark/tests/test_harness_hold.py -q
"""

import functools
import time
from unittest import mock

import pytest

import harness

CELL = "ldp_1080p_m7_qp32.pan"
VBR = "vbr10_1080p_m8.reveal"
SMALL = (320, 256)
SEED = 2 ** 31 + 23


class Hoarder:
    """A program that reads its whole feed before it yields anything."""

    pulls = 0
    feed = None

    def __init__(self, cfg, device=None):
        Hoarder.pulls, Hoarder.feed = 0, None

    def encode_pictures(self, frames):
        Hoarder.feed = frames
        for _ in frames:
            Hoarder.pulls += 1
        yield from ()


def hoarding():
    return mock.patch("svt_hevc_tpu_torch.Encoder", Hoarder)


def test_a_program_that_holds_the_feed_is_stopped_after_the_bound():
    with hoarding(), pytest.raises(harness.HeldFeed) as e:
        harness.execute(CELL, SEED, 2.0, False, time.perf_counter(),
                        device="cpu", dims=SMALL)
    # the program took HOLD_MAX frames; the pull past them was refused
    assert Hoarder.pulls == harness.HOLD_MAX
    assert Hoarder.feed.i == harness.HOLD_MAX + 1
    assert f"held {harness.HOLD_MAX + 1} frames" in str(e.value)
    assert f"(bound {harness.HOLD_MAX})" in str(e.value)
    assert str(e.value).endswith("yielded so far: none")


def test_run_exits_nonzero_with_no_result_and_names_the_bound(
        monkeypatch, capsys):
    import torch

    import run
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS",
                "OPENBLAS_NUM_THREADS", "TORCH_EXTENSIONS_DIR",
                "TRITON_CACHE_DIR"):      # main sets them; restored after
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(harness, "execute", functools.partial(
        harness.execute, device="cpu", dims=SMALL))
    with hoarding():
        rc = run.main(["--workload", CELL, "--seed", str(SEED),
                       "--seconds", "2", "--trace", "0"])
    out, err = capsys.readouterr()
    assert rc != 0
    assert out == ""
    last = err.strip().splitlines()[-1]
    assert last.startswith(f"the program held {harness.HOLD_MAX + 1} frames "
                           f"pulled and not yet yielded (bound "
                           f"{harness.HOLD_MAX})")


def test_index_ranges():
    assert harness.index_ranges([]) == "none"
    assert harness.index_ranges([4, 0, 1, 2, 8, 3, 10, 11]) == "0-4, 8, 10-11"


# The most frames each cell's configuration holds. Low-delay P under CQP
# pipelines one picture deep: the next frame is pulled before the
# previous access unit is yielded, so 2. VBR with its lookahead of la
# (17) refills its queue to 2 (la + 1) frames whenever it falls under
# la + 1, and its pictures are not pipelined: 36 held, at the first
# refill and at each later one; one more if they come to be pipelined.
HELD = {CELL: lambda cfg: 2,
        VBR: lambda cfg: 2 * (cfg.lookahead + 1) + 1}


@pytest.mark.parametrize("cell", sorted(HELD))
def test_each_cell_holds_far_under_the_bound(cell):
    q = dict(harness.load_cell(cell)["quality"], first=3, count=3)
    with mock.patch.object(harness, "load_cell",
                           lambda name: {"quality": q}), \
            mock.patch.object(harness, "log") as log:
        run = harness.Run(cell, SEED, 0.5, False, time.perf_counter(),
                          device="cpu", dims=SMALL)
        run.setup()
        run.window()
    line = next(c.args[0] for c in log.call_args_list
                if c.args[0].startswith("held at most "))
    held = int(line.split()[3])
    assert held == run.feed.held_max
    assert 1 <= held <= HELD[cell](run.cfg) <= harness.HOLD_MAX // 16
