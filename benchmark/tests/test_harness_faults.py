"""A whole run, on the CPU at a small size and without the look for a
card, with the timed path broken underneath: `correct` has to come out
false for the controls and each fault a cell can have (faults.py), and
true without one. The cells run one stream on one card, so the faults of
batches and of exchanges between cards do not apply.

The quality check's expectation holds at the cell's own size; here it is
taken from a sound run of the same seed at the test's size, over a
shorter range of pictures, with the cell's own limit."""

import contextlib
import time
from unittest import mock

import pytest

import harness
from faults import FAULTS

CELL = "ldp_1080p_m7_qp32.pan"
VBR = "vbr10_1080p_m8.reveal"
SMALL = (320, 256)
SEED = 2 ** 31 + 11
# where each fault shows on the CPU: the cell and the picture size (the
# zero motion centres cost little where the 96x96 object fills a tenth of
# 320x256 and wraps every 17 pictures)
PLANTS = {"sao_skip": (CELL, SMALL), "dlf_unchanged": (CELL, SMALL),
          "stale_reference": (CELL, SMALL), "token_altered": (CELL, SMALL),
          "hme_off": (CELL, (640, 384)), "hme_wrong": (CELL, SMALL),
          "intra_off": (VBR, SMALL)}
_EXPECT: dict = {}


def small_cell(cell, expect):
    q = dict(harness.load_cell(cell)["quality"], first=3, count=3,
             expect=expect)
    return mock.patch.object(harness, "load_cell",
                             lambda name: {"quality": q})


def execute(cell, seed, dims):
    return harness.execute(cell, seed, 2.0, False, time.perf_counter(),
                           device="cpu", dims=dims)


def expect_of(cell, dims):
    """bytes and PSNR of a sound run at dims (SEED)."""
    if (cell, dims) not in _EXPECT:
        with small_cell(cell, {"bytes": 1, "psnr_y_db": 0.0}), \
                mock.patch.object(harness, "log") as log:
            execute(cell, SEED, dims)
        line = next(c.args[0] for c in log.call_args_list
                    if c.args[0].startswith("quality over"))
        nbytes = int(line.split(": ")[1].split(" bytes")[0])
        db = float(line.split("PSNR-Y ")[1].split(" dB")[0])
        _EXPECT[cell, dims] = {"bytes": nbytes, "psnr_y_db": db}
    return _EXPECT[cell, dims]


def run(cell, plant, seed=SEED, dims=SMALL):
    with small_cell(cell, expect_of(cell, dims)), plant:
        return execute(cell, seed, dims)


def test_sound_run_is_correct():
    out = run(CELL, contextlib.nullcontext())
    assert out["correct"], out["checks"]
    assert out["checks"]["pictures_wrong"]["value"] == 0
    assert out["checks"]["rate_loss_pct"]["value"] == pytest.approx(0.0)
    assert list(out)[-1] == "checks"
    assert {"fps", "latency_p90_ms", "setup_s"} <= set(out["metrics"])


def test_every_fault_is_planted():
    assert set(PLANTS) == set(FAULTS)


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_fault_makes_the_run_not_correct(fault):
    cell, dims = PLANTS[fault]
    out = run(cell, FAULTS[fault](), dims=dims)
    assert not out["correct"], (fault, out["checks"])


@pytest.mark.parametrize("fault", ["hme_off", "hme_wrong", "intra_off"])
def test_decision_faults_fail_the_quality_check_alone(fault):
    cell, dims = PLANTS[fault]
    out = run(cell, FAULTS[fault](), dims=dims)
    c = out["checks"]
    assert c["pictures_wrong"]["value"] == 0, c
    assert c["rate_loss_pct"]["value"] > c["rate_loss_pct"]["limit"], c


def test_control_fails_the_vbr_cell():
    out = run(VBR, FAULTS["sao_skip"]())
    assert not out["correct"], out["checks"]


@pytest.mark.card
@pytest.mark.parametrize("cell,fault", [
    (c["name"], f) for c in harness.manifest()["workloads"]
    for f in harness.load_cell(c["name"])["controls"]])
def test_controls_fail_at_the_cells_size_on_the_card(card, cell, fault):
    for seed in (101, 102, 103):
        with FAULTS[fault]():
            out = harness.execute(cell, seed, 3.0, False,
                                  time.perf_counter())
        assert not out["correct"], (seed, out["checks"])
