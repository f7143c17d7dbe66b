"""BENCHMARK.json against the benchmark's contract, and a cell, traffic
mix and metric added as files and entries alone."""

import json
import re
import shutil

import pytest

from perfbench import harness

NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.\-]{1,16}")
PATH = re.compile(r"[A-Za-z0-9_.\-/]{1,200}")
LINE = re.compile(r"[^\t\n]{1,200}")
TOP = {"command", "paths", "run_seconds", "configs", "workloads",
       "end_to_end", "per_layer"}


@pytest.fixture(scope="module")
def man():
    return harness.manifest()


def test_keys_names_and_units(man):
    assert set(man) == TOP
    assert 1 <= man["run_seconds"] <= 51
    assert all(PATH.fullmatch(p) and not p.startswith("/") and ".." not in p
               for p in man["paths"])
    assert len(man["command"]) <= 32 and all(LINE.fullmatch(w)
                                             for w in man["command"])
    names = []
    for c in man["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith(tuple(p + "/" for p in man["paths"]))
        assert all(NAME.fullmatch(k) for k in c["reduced"])
        assert LINE.fullmatch(c["why"]) and LINE.fullmatch(c["source"])
        names.append(c["name"])
    for w in man["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and LINE.fullmatch(w["why"])
        assert NAME.fullmatch(w["config"]) and NAME.fullmatch(w["traffic"])
        names.append(w["name"])
    for m in man["end_to_end"] + man["per_layer"]:
        assert UNIT.fullmatch(m["unit"]) and m["better"] in ("lower",
                                                             "higher")
        names.append(m["name"])
    for m in man["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "bound", "source"}
        assert 0.01 <= m["bound"] <= 0.25
    for m in man["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "source", "layer", "moves"}
        assert LINE.fullmatch(m["layer"])
        assert m["moves"] in {e["name"] for e in man["end_to_end"]}
    assert all(NAME.fullmatch(n) for n in names)
    assert len(names) == len(set(names))
    assert "setup_s" in {m["name"] for m in man["end_to_end"]}


def test_every_cell_finds_its_files_by_name(man):
    for w in man["workloads"]:
        cell = harness.Cell.load(w["name"])
        config = next(c for c in man["configs"] if c["name"] == w["config"])
        assert cell.config["name"] == w["config"]
        assert cell.config["reduced"] == config["reduced"]
        assert set(cell.limits) == {"tracer_off", "denoiser_off"}
        assert (harness.REPO / cell.config["scene"]).is_file()
        for m in cell.end_to_end + cell.per_layer:
            assert callable(harness.reader(m["name"]))
        assert {m["name"] for m in cell.end_to_end} >= {"setup_s",
                                                         "frame_ms"}


def test_a_cell_traffic_and_metric_added_as_files(tmp_path, man):
    """A new traffic mix, metric and cell: new files and new entries in a
    copy of the manifest, no file of the benchmark edited."""
    root = tmp_path / "checkout"
    shutil.copytree(harness.REPO / "perfbench", root / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in (root / "perfbench").rglob("*")
              if p.is_file()}
    (root / "perfbench" / "traffic" / "dolly.json").write_text(json.dumps({
        "loop_frames": 60, "warmup_frames": 60,
        "axes": {"look_at_z": {"center": 0.0, "amplitude": 0.5,
                               "cycles": 1}}}))
    (root / "perfbench" / "metrics" / "frames_seen.py").write_text(
        "def read(run):\n    return float(len(run.frame_s))\n")
    (root / "perfbench" / "limits" / "cornell_800.dolly.json").write_text(
        json.dumps({"tracer_off": 0.001, "denoiser_off": 0.001}))
    new = json.loads(json.dumps(man))
    new["workloads"].append({"name": "cornell_800.dolly",
                             "config": "cornell_800", "traffic": "dolly",
                             "chips": 1, "why": "a test cell"})
    new["per_layer"].append({"name": "frames_seen", "unit": "frames",
                             "better": "higher", "source": "host_clock",
                             "layer": "device (H100)", "moves": "frame_ms",
                             "workloads": ["cornell_800.dolly"]})
    (root / "BENCHMARK.json").write_text(json.dumps(new))
    cell = harness.Cell.load("cornell_800.dolly", root)
    assert cell.traffic["loop_frames"] == 60
    assert [m["name"] for m in cell.per_layer][-1] == "frames_seen"
    run = harness.Run(frame_s=[0.1, 0.2], window_s=0.3, setup_s=1.0,
                      pixels=1, depth=8)
    assert harness.reader("frames_seen", root)(run) == 2.0
    # the old cells do not report the new metric
    assert "frames_seen" not in [
        m["name"] for m in harness.Cell.load("cornell_800.still",
                                             root).per_layer]
    for p, data in before.items():
        assert p.read_bytes() == data
