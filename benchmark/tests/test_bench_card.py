"""One short run of each cell on the card (skips without one, or
without as many cards as the cell asks for)."""

import json
import subprocess
import sys

import pytest

from benchmark.tests import fixture_cell

BENCH = json.loads((fixture_cell.REPO / "BENCHMARK.json").read_text())


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_runs_on_the_card(cell):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card; torch sees none")
    chips = {w["name"]: w["chips"] for w in BENCH["workloads"]}[cell]
    if torch.cuda.device_count() < chips:
        pytest.skip(f"the cell needs {chips} cards; torch sees "
                    f"{torch.cuda.device_count()}")
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", cell, "--seed",
         "2147483699", "--seconds", "3", "--trace", "0"],
        capture_output=True, text=True, timeout=1200, cwd=fixture_cell.REPO,
    )
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] is True
    assert result["device"]["platform"] == "gpu"
