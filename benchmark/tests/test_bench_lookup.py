"""Every file BENCHMARK.json names is found by its name, and a cell made
of added fixture files alone runs through the same lookup."""

import json
import re

import pytest

from benchmark import harness
from benchmark.tests import fixture_cell

BENCH = json.loads((fixture_cell.REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_found(cell):
    spec = harness.Spec(fixture_cell.REPO, cell)
    assert spec.config["name"] == spec.cell["config"]
    assert spec.config["reduced"] == spec.config_entry["reduced"]
    assert spec.traffic["api"]
    for m in spec.metrics(False) + spec.metrics(True):
        assert callable(spec.reader(m["name"]))
    names = {m["name"] for m in spec.metrics(False)}
    assert "setup_s" in names and len(names) >= 2
    assert spec.metrics(True)


@pytest.mark.parametrize("metric", METRICS)
def test_metric_reader_found(metric):
    spec = harness.Spec(fixture_cell.REPO, CELLS[0])
    assert callable(spec.reader(metric))


def test_names_units_and_keys():
    assert set(BENCH) == {
        "command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer",
    }
    for entry in BENCH["configs"] + BENCH["workloads"] + METRICS_ENTRIES():
        assert NAME.match(entry["name"]), entry["name"]
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}, c
        assert all(0 < len(c[k]) <= 200 for k in ("source", "why"))
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}, w
    for m in BENCH["end_to_end"]:
        keys = {"name", "unit", "better", "bound", "source"}
        assert keys <= set(m) <= keys | {"workloads"}, m
    for m in BENCH["per_layer"]:
        keys = {"name", "unit", "better", "source", "layer", "moves"}
        assert keys <= set(m) <= keys | {"workloads"}, m
    for m in METRICS_ENTRIES():
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", CELLS)) <= set(CELLS)
    for w in BENCH["workloads"]:
        assert len(w["why"]) <= 200 and w["chips"] in (1, 4)
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(BENCH["workloads"]) // 4)
    assert all(m["bound"] <= 0.25 for m in BENCH["end_to_end"])
    assert len(json.dumps(BENCH)) < 64 << 10


def METRICS_ENTRIES():
    return BENCH["end_to_end"] + BENCH["per_layer"]


def test_unknown_cell_fails():
    with pytest.raises(harness.Failure) as err:
        harness.Spec(fixture_cell.REPO, "no.such.cell")
    assert err.value.code != 0


@pytest.mark.parametrize("traced", [False, True])
def test_fixture_cell_runs(tmp_path, monkeypatch, traced):
    out = fixture_cell.run(tmp_path, monkeypatch, traced=traced)
    assert out["correct"] is True
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert list(out)[-1] == "check"
    assert all(v["value"] == 0 for v in out["check"].values())
    if traced:
        assert "host_ms.gcups" in out["metrics"]
        assert out["device"]["window_s"] > 0
        assert "breakdown" in out
    else:
        assert set(out["metrics"]) == {"gcups", "setup_s"}


def test_fixture_query_cell_runs(tmp_path, monkeypatch):
    out = fixture_cell.run(
        tmp_path, monkeypatch, api="align", per_call=1, lengths=(40, 70),
        one_query=True, check={"calls": 1, "targets": "all"},
    )
    assert out["correct"] is True
    assert set(out["metrics"]) == {"query_p50_ms", "query_p95_ms", "setup_s"}


def test_checkout_without_package_fails(tmp_path):
    (tmp_path / "benchmark").mkdir()
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(BENCH))
    for c in BENCH["configs"]:
        dst = tmp_path / c["file"]
        dst.parent.mkdir(parents=True, exist_ok=True)
        dst.write_text((fixture_cell.REPO / c["file"]).read_text())
    with pytest.raises(harness.Failure) as err:
        harness.run_cell(
            tmp_path, CELLS[0], 1, 1.0, False, device="cpu",
            require_cuda=False,
        )
    assert err.value.code == 4
