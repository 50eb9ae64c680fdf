"""BENCHMARK.json against the benchmark's contract: names, units, the
allowed characters and keys, and a file for each configuration, mix and
metric, found by name."""

import json
import os
import re

import pytest

import harness
from conftest import BENCH, ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
LINE = re.compile(r"^[^\t\n\r]{1,200}$")
METRIC_KEYS = {"name", "unit", "better", "source"}


def manifest():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_top_level_keys_and_command():
    m = manifest()
    assert set(m) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(m["paths"]) <= 16
    for p in m["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert os.path.isdir(os.path.join(ROOT, p))
    assert len(m["command"]) <= 32
    for word in m["command"]:
        assert LINE.match(word)
        if word.endswith(".py"):
            assert any(word.startswith(p + "/") for p in m["paths"])
    assert isinstance(m["run_seconds"], int) and 1 <= m["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 65536


def test_configs_and_their_files():
    m = manifest()
    assert 1 <= len(m["configs"]) <= 24
    names = [c["name"] for c in m["configs"]]
    assert len(set(names)) == len(names)
    used = {w["config"] for w in m["workloads"]}
    files = set()
    for c in m["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["name"] in used
        assert LINE.match(c["source"]) and LINE.match(c["why"])
        assert c["file"] == f"benchmark/configs/{c['name']}.json"
        assert c["file"] not in files
        files.add(c["file"])
        with open(os.path.join(ROOT, c["file"])) as f:
            conf = json.load(f)
        assert conf["source"] == c["source"]
        assert conf["reduced"] == c["reduced"] and len(c["reduced"]) <= 16
        assert ("cli" in conf) != ("encoder" in conf)


def test_workloads():
    m = manifest()
    cells = m["workloads"]
    assert 1 <= len(cells) <= 24
    assert len({c["name"] for c in cells}) == len(cells)
    assert len({(c["config"], c["traffic"]) for c in cells}) == len(cells)
    assert sum(c["chips"] == 4 for c in cells) <= max(1, len(cells) // 4)
    for c in cells:
        assert set(c) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(c["name"]) and NAME.match(c["traffic"])
        assert c["chips"] in (1, 4) and LINE.match(c["why"])
        assert os.path.exists(os.path.join(BENCH, "traffic",
                                           c["traffic"] + ".json"))


@pytest.mark.parametrize("cell", [c["name"] for c in manifest()["workloads"]])
def test_each_cell_states_the_quality_it_is_held_to(cell):
    from faults import FAULTS
    assert set(harness.load_cell(cell)["controls"]) <= set(FAULTS)
    q = harness.load_cell(cell)["quality"]
    assert set(q) == {"first", "count", "expect", "limit_rate_loss_pct"}
    assert q["first"] > harness.SETUP_P and q["count"] >= 16
    assert q["expect"]["bytes"] > 0 and q["expect"]["psnr_y_db"] > 0
    assert 0 < q["limit_rate_loss_pct"] < 100


def test_metrics_and_their_readers():
    m = manifest()
    cells = {c["name"] for c in m["workloads"]}
    e2e = {x["name"]: x for x in m["end_to_end"]}
    assert 1 <= len(e2e) <= 16 and "setup_s" in e2e
    assert 1 <= len(m["per_layer"]) <= 128
    names = [x["name"] for x in m["end_to_end"] + m["per_layer"]]
    assert len(set(names)) == len(names)
    for x in m["end_to_end"]:
        assert set(x) - {"workloads"} == METRIC_KEYS | {"bound"}
        assert x["source"] in ("host_clock", "device_trace")
        assert 0.01 <= x["bound"] <= 0.25
    assert e2e["setup_s"]["bound"] <= 0.25
    layers = {}
    for x in m["per_layer"]:
        assert set(x) - {"workloads"} == METRIC_KEYS | {"layer", "moves"}
        assert x["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert LINE.match(x["layer"]) and x["moves"] in e2e
        if x["name"].endswith("_roofline"):
            assert x["unit"] == "%"
        for cell in x.get("workloads", cells):
            assert cell in cells
            assert cell in e2e[x["moves"]].get("workloads", cells)
        layers.setdefault(x["layer"], []).append(x["name"])
    for x in m["end_to_end"] + m["per_layer"]:
        assert NAME.match(x["name"]) and UNIT.match(x["unit"])
        assert x["better"] in ("lower", "higher")
        assert os.path.exists(os.path.join(BENCH, "metrics",
                                           x["name"] + ".py"))
    for cell in cells:       # every cell: setup_s, another e2e, a per-layer
        mine = [x for x in m["end_to_end"]
                if cell in x.get("workloads", cells)]
        assert len(mine) >= 2 and any(x["name"] == "setup_s" for x in mine)
        assert any(cell in x.get("workloads", cells) for x in m["per_layer"])


@pytest.mark.parametrize("cell", [c["name"] for c in manifest()["workloads"]])
def test_each_cell_builds_its_configuration(cell):
    import harness
    c = harness.entry(manifest()["workloads"], cell)
    cfg = harness.encoder_config(harness.load_config(c["config"]))
    assert (cfg.width, cfg.height) == (1920, 1080)
    ex = harness.expectations(cfg)
    assert ex["sao"] and ex["deblocking"] and ex["tmvp"]
