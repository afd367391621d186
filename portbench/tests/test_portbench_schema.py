"""The result line's schema and the cells' files, found by name."""

import json
import os
import re

from portbench import harness
from portbench.harness import Run

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _bench():
    return harness.load_json(os.path.join(harness.ROOT, "BENCHMARK.json"))


def test_result_line_schema():
    cell = harness.find_cell("kitti_hdl64.odometry_window")
    run = Run(attempted=10, failed=1, e2e={"odom_frames_per_s": 30.0, "setup_s": 12.0},
              checks={"pose_gap_m": (1e-4, 1e-3)}, ctx={}, device_extra={"platform": "gpu", "kind": "x",
                                                                           "count": 1, "memory_peak_bytes": 5})
    line = harness.result_line(cell, run, run.device_extra, trace=False)
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True and set(line["metrics"]) == {"odom_frames_per_s", "setup_s"}
    assert line["metrics"]["setup_s"] == {"value": 12.0, "unit": "s"}
    run.breakdown = {"device_ops": [["k", 0.1]], "idle_gaps": [["stack_scans", 0.2]]}
    run.checks["pose_gap_m"] = (2e-3, 1e-3)
    traced = harness.result_line(cell, run, run.device_extra, trace=True)
    assert traced["correct"] is False and "breakdown" in traced and list(traced)[-1] == "checks"
    json.dumps(traced)


def test_a_nan_reading_is_not_correct():
    assert not Run(attempted=1, failed=0, e2e={}, checks={"x": (float("nan"), 1.0)}).correct


def test_each_cell_finds_its_files_by_name():
    bench = _bench()
    for w in bench["workloads"]:
        cell = harness.find_cell(w["name"])
        assert cell.config["name"] == w["config"]
        assert harness.entry(cell.mix["entry"]).run
        assert {m["name"] for m in cell.end_to_end} >= {"setup_s"}
        assert len(cell.end_to_end) >= 2 and cell.per_layer
        for m in cell.per_layer:
            assert callable(harness.metric_reader(m["name"]))
        assert set(cell.mix["limits"]) and all(v >= 0 for v in cell.mix["limits"].values())


def test_benchmark_json_keeps_the_contract_shape():
    bench = _bench()
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["portbench"] and 1 <= bench["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer") for x in bench[k]]
    assert all(NAME.match(n) for n in names)
    assert len({x["name"] for x in bench["end_to_end"] + bench["per_layer"]}) == len(bench["end_to_end"]) + len(bench["per_layer"])
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and c["file"].startswith("portbench/")
        assert harness.load_json(os.path.join(harness.ROOT, c["file"]))["reduced"] == c["reduced"]
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] in (1, 4)
        assert len(w["why"]) <= 200
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace") and UNIT.match(m["unit"])
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["moves"] in {e["name"] for e in bench["end_to_end"]} and UNIT.match(m["unit"])
        if m["name"].endswith(("_roofline", ) ) or "_roofline." in m["name"]:
            assert m["unit"] == "%"
    assert len(json.dumps(bench)) < 64 * 1024
