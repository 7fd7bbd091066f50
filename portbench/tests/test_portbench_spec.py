"""Every entry of BENCHMARK.json resolves to its files by name, and the
file keeps to the shapes the benchmark's contract sets."""

import json
import re

import pytest
from portbench_cells import ROOT

from portbench import bench

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in SPEC["workloads"]]
METRICS = [m["name"] for m in SPEC["per_layer"]]


def test_top_level_keys_and_limits():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert 1 <= SPEC["run_seconds"] <= 51 and isinstance(SPEC["run_seconds"], int)
    assert SPEC["paths"] == ["portbench"] and len(SPEC["command"]) <= 32
    assert (ROOT / SPEC["command"][1]).is_file()
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    names = [x["name"] for key in ("configs", "workloads", "end_to_end", "per_layer")
             for x in SPEC[key]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)


@pytest.mark.parametrize("config", SPEC["configs"], ids=lambda c: c["name"])
def test_config_file(config):
    assert set(config) == {"name", "source", "file", "reduced", "why"}
    params = json.loads((ROOT / config["file"]).read_text())
    assert params["name"] == config["name"] and params["source"] == config["source"]
    assert 1 <= len(config["source"]) <= 200 and "\n" not in config["source"]
    assert sorted(config["reduced"]) == sorted(params["reduced"])
    for key in config["reduced"]:
        assert NAME.match(key) and params[key] == params["reduced"][key]["here"]
    assert params["generator"]["documents_key"] in params
    assert any(w["config"] == config["name"] for w in SPEC["workloads"])


@pytest.mark.parametrize("name", CELLS)
def test_listed_cell_matches_its_file(name):
    w = next(w for w in SPEC["workloads"] if w["name"] == name)
    assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] in (1, 4)
    assert len(w["why"]) <= 200
    c = bench.cell(name)
    assert (c["name"], c["config"], c["traffic"], c["chips"], c["why"]) == (
        name, w["config"], w["traffic"], w["chips"], w["why"])
    e2e = [m["name"] for m in c["end_to_end"]]
    assert "setup_s" in e2e and len(e2e) >= 2 and c["per_layer"]
    for m in c["per_layer"]:
        assert m["moves"] in e2e


@pytest.mark.parametrize("path", sorted((bench.HERE / "workloads").glob("*.json")),
                         ids=lambda p: p.stem)
def test_every_cell_file_resolves_by_name(path):
    c = bench.cell(path.stem)
    assert c["name"] == path.stem and c["chips"] in (1, 4)
    assert c["config_params"]["name"] == c["config"]
    assert hasattr(bench.entry(c["entry"]["kind"]), "run")
    assert hasattr(bench.entry(c["entry"]["kind"]), "control")
    assert c["limits"] and all(isinstance(v, (int, float)) for v in c["limits"].values())
    assert "setup_s" in [m["name"] for m in c["end_to_end"]]


@pytest.mark.parametrize("name", METRICS)
def test_metric_reader_resolves_by_name(name):
    m = next(m for m in SPEC["per_layer"] if m["name"] == name)
    assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
    assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    assert m["workloads"] and set(m["workloads"]) <= set(CELLS)
    mod = bench.load_module(bench.HERE / "metrics" / f"{name}.py")
    assert callable(mod.read)
    if "roofline" in name or "mfu" in name:
        assert m["unit"] == "%" and name.split(".")[0].endswith(("_roofline", "mfu"))


def test_end_to_end_metrics():
    assert SPEC["end_to_end"][-1]["name"] == "setup_s"
    for m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and UNIT.match(m["unit"])
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m.get("workloads", CELLS)) <= set(CELLS)


def test_check_fits_its_time():
    cells = 24
    per_check = (2 + 14 * cells) * (SPEC["run_seconds"] + 60) + cells * 180 + 1200
    assert per_check <= 43200


def test_each_pair_of_config_and_traffic_once():
    pairs = [(w["config"], w["traffic"]) for w in SPEC["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_traffic_files_resolve():
    for path in (bench.HERE / "traffic").glob("*.json"):
        assert json.loads(path.read_text())["kind"] == "builds"


@pytest.mark.parametrize("path", sorted((bench.HERE / "metrics").glob("*.py")),
                         ids=lambda p: p.stem)
def test_every_metric_file_has_a_reader(path):
    assert callable(bench.load_module(path).read)
