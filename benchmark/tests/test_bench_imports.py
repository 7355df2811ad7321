"""Nothing the benchmark runs loads JAX or the JAX package, compared by
whole top-level module names (``pyopal_tpu_torch`` begins with
``pyopal_tpu`` and is allowed); the reference loads nothing of the
program."""

import json
import subprocess
import sys

from benchmark.tests import fixture_cell

FORBIDDEN = {"jax", "jaxlib", "flax", "pyopal_tpu"}

RUN_FIXTURE = """
import json, sys, tempfile
from pathlib import Path
sys.path.insert(0, {repo!r})
from benchmark import harness
from benchmark.tests import fixture_cell
harness.PREPARED_CALLS = 8
with tempfile.TemporaryDirectory() as tmp:
    root, data, name = fixture_cell.make_cell(Path(tmp))
    out = harness.run_cell(root, name, 7, 0.2, True, device="cpu",
                           require_cuda=False, data_dir=data)
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""

RUN_REFERENCE = """
import json, sys
sys.path.insert(0, {repo!r})
import numpy as np
from benchmark import check, generate, reference
lens = np.array([5, 9])
codes = np.arange(14, dtype=np.uint8) % 20
print(reference.sw_scores([codes[:4]], codes, generate.offsets_of(lens), lens,
                          [0, 1], np.eye(20, dtype=int), 3, 1, device="cpu").tolist(),
      file=sys.stderr)
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def loaded(code):
    out = subprocess.run(
        [sys.executable, "-c", code.format(repo=str(fixture_cell.REPO))],
        capture_output=True, text=True, timeout=600, cwd="/",
    )
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax():
    mods = loaded(RUN_FIXTURE)
    assert "pyopal_tpu_torch" in mods and "benchmark" in mods
    assert not (mods & FORBIDDEN), mods & FORBIDDEN


def test_reference_loads_nothing_of_the_program():
    mods = loaded(RUN_REFERENCE)
    assert "torch" in mods
    assert not any(m.startswith("pyopal_tpu") for m in mods)


def test_harness_check_by_whole_names(monkeypatch):
    from benchmark import harness

    monkeypatch.setitem(sys.modules, "pyopal_tpu_torch_like", sys)
    assert "pyopal_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert harness.forbidden_modules() == ["jax"]


def test_no_card_no_result():
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "sprot12071.batch256", "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=fixture_cell.REPO,
        env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""},
    )
    assert out.returncode != 0
    assert out.stdout.strip() == ""
