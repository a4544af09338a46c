"""The harness finds every part of a cell by name, refuses unknown
names, and picks up a new configuration and metric added as files."""
from __future__ import annotations

import json
import re
import shutil

import pytest

from portbench_tiny import ROOT
from portbench import harness as H

BENCH = H.load_benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def test_every_part_is_found_by_name():
    for w in BENCH["workloads"]:
        cf = H.load_config(w["config"])
        tr = H.load_traffic(w["traffic"])
        H.load_kind(tr["kind"])
        assert H.load_limits(w["name"])
        assert (ROOT / cf["weights"]).is_file()
    for m in BENCH["per_layer"]:
        assert hasattr(H.load_reader(m["name"]), "read")


@pytest.mark.parametrize("load,name", [
    (H.load_config, "no_such_config"), (H.load_traffic, "no_such_mix"),
    (H.load_kind, "no_such_kind"), (H.load_reader, "no_such_metric"),
    (H.load_limits, "no_such.cell")])
def test_unknown_names_are_refused(load, name):
    with pytest.raises(H.UnknownName):
        load(name)


def test_unknown_workload_is_refused():
    with pytest.raises(H.UnknownName):
        H.find_cell(BENCH, "al1d_200k.no_such_traffic")


def test_limits_cover_every_reading():
    with pytest.raises(H.UnknownName):
        H.checks_from({"design_gap": 0.0, "unlimited": 1.0},
                      {"design_gap": 1.0})


def test_new_files_are_picked_up_without_edits(tmp_path):
    base = tmp_path / "portbench"
    shutil.copytree(ROOT / "portbench", base,
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in base.rglob("*") if p.is_file()}
    cf = json.loads((base / "configs" / "al1d_200k.json").read_text())
    cf["name"] = "al1d_200k_copy"
    (base / "configs" / "al1d_200k_copy.json").write_text(json.dumps(cf))
    (base / "metrics" / "units_done.py").write_text(
        "def read(run):\n    return float(run.units)\n")
    assert H.load_config("al1d_200k_copy", base)["name"] == "al1d_200k_copy"
    run = H.Run(cf, {}, units=7)
    assert H.load_reader("units_done.live", base).read(run) == 7.0
    after = {p: p.read_bytes() for p in before}
    assert after == before


def test_benchmark_file_keeps_the_contract():
    keys = {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"}
    assert set(BENCH) == keys
    assert len(json.dumps(BENCH)) < 64 * 1024
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [c["name"] for c in BENCH["configs"]]
    cells = [w["name"] for w in BENCH["workloads"]]
    metrics = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    for group in (names, cells, metrics):
        assert len(group) == len(set(group))
        assert all(NAME.match(n) for n in group)
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("portbench/") and len(c["why"]) <= 200
        assert any(w["config"] == c["name"] for w in BENCH["workloads"])
    pairs = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and 1 <= len(w["why"]) <= 200
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25 and UNIT.match(m["unit"])
    for m in BENCH["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e and UNIT.match(m["unit"])
        for w in m["workloads"]:
            assert w in cells
            assert w in e2e[m["moves"]].get("workloads", cells)
    for w in cells:
        own = [m for m in BENCH["end_to_end"] if w in
               m.get("workloads", cells)]
        assert len(own) >= 2
        assert any(w in m["workloads"] for m in BENCH["per_layer"])
