"""A run stops every process it started before it prints its line: the
resource tracker that the check's spawned pool leaves behind, and any
other child that outlives its work."""

import multiprocessing
import os
import subprocess
import sys
from concurrent.futures import ProcessPoolExecutor

import pytest

import harness


def _square(x):
    return x * x


def test_the_checks_pool_leaves_its_tracker_until_stopped():
    ctx = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(max_workers=2, mp_context=ctx) as pool:
        assert list(pool.map(_square, range(4))) == [0, 1, 4, 9]
    # the pool's workers have ended; the tracker they used has not
    assert harness.children()
    assert harness.stop_children() == []
    assert harness.children() == []


def test_a_child_that_outlives_its_grace_is_killed_and_reaped():
    p = subprocess.Popen([sys.executable, "-c",
                          "import time; time.sleep(120)"])
    assert p.pid in harness.stop_children(grace=0.5)
    assert harness.children() == []
    with pytest.raises(ProcessLookupError):
        os.kill(p.pid, 0)
