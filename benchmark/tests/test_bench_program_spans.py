"""The readers of the program's own counters: the useful share of the
cells the kernels walk gives None where the program keeps no counters
(or holds counts from outside the window), and the share where it does;
and every function `LAYER_SPANS` wraps is one the program has."""

import importlib

import pytest

from benchmark import tracing
from benchmark.tests import fixture_cell
from benchmark.tests.test_bench_arith import fake_run, reader

USEFUL_READERS = ["useful_cells_pct.gcups", "useful_cells_pct.query"]
CALLS = [(0.0, 0.04, 2_000, 1), (0.05, 0.1, 1_500, 1)]


@pytest.mark.parametrize("name", USEFUL_READERS)
def test_useful_cells_readers(name, monkeypatch):
    profiling = importlib.import_module("pyopal_tpu_torch.utils.profiling")
    counted = {"cells.needed": 3_000, "cells.walked": 4_000}
    monkeypatch.setattr(profiling, "counters", lambda: dict(counted))
    assert reader(name)(fake_run(CALLS)) == pytest.approx(75.0)
    counted["cells.needed"] = 3_501  # more than the window's calls had
    assert reader(name)(fake_run(CALLS)) is None
    counted.clear()  # nothing counted: nothing to read
    assert reader(name)(fake_run(CALLS)) is None


@pytest.mark.parametrize("name", USEFUL_READERS)
def test_useful_cells_readers_without_program_counters(name, monkeypatch):
    profiling = importlib.import_module("pyopal_tpu_torch.utils.profiling")
    monkeypatch.delattr(profiling, "counters")  # a program without them
    assert reader(name)(fake_run(CALLS)) is None


@pytest.mark.parametrize("entry", tracing.LAYER_SPANS, ids=lambda e: e[1])
def test_layer_spans_resolve(entry):
    mod_name, attr, _ = entry
    assert callable(getattr(importlib.import_module(mod_name), attr))


def test_fixture_cell_reports_program_metrics(tmp_path, monkeypatch):
    profiling = importlib.import_module("pyopal_tpu_torch.utils.profiling")
    profiling.reset_counters()
    out = fixture_cell.run(tmp_path, monkeypatch, traced=True)
    assert out["correct"] is True
    useful = out["metrics"]["useful_cells_pct.gcups"]["value"]
    assert 0 < useful <= 100
