"""The port's ``utils`` (device info, profiling) and type stubs against
the JAX package's.
"""

import ast
import inspect
import json
import os
from pathlib import Path

import numpy as np
import pytest
import torch

import pyopal_tpu as po
import pyopal_tpu_torch as pt
from pyopal_tpu.utils import profiling as ref_profiling
from pyopal_tpu_torch import parallel
from pyopal_tpu_torch.ops import _cuda, ragged
from pyopal_tpu_torch.utils import profiling
import _torch_cpu  # noqa: F401  (torch threads: a worker's share)

REPO = Path(__file__).resolve().parent.parent


def _outcome(fn, *args, **kwargs):
    try:
        return "value", fn(*args, **kwargs)
    except Exception as err:  # the outcome compared is the exception
        return type(err).__name__, str(err)


@pytest.mark.parametrize("args", [
    (256, 4_683_440, 0.0424), (1, 1, 1.0), (5, 7, 0.0), (5, 7, None),
    (0, 100, 2.5),
])
def test_gcups_matches_reference(args):
    assert _outcome(profiling.gcups, *args) == _outcome(
        ref_profiling.gcups, *args)


def test_timer_matches_reference():
    for mod in (profiling, ref_profiling):
        t = mod.Timer(256, 1000)
        assert t.seconds is None
        with pytest.raises(RuntimeError, match="has not exited yet"):
            t.gcups
    t = profiling.Timer(256, 10**9)
    with t as entered:
        sum(range(1000))
    assert entered is t
    assert isinstance(t.seconds, float) and t.seconds > 0
    assert t.gcups == profiling.gcups(256, 10**9, t.seconds)


@pytest.mark.parametrize("bounds", [(0, None), (5, 30), (3, 3), (0, 10**6),
                                    (-1, None), (10, 5)])
def test_search_stats_match_reference(bounds):
    rng = np.random.default_rng(5)
    letters = "ARNDCQEGHILKMFPSTWYV"
    seqs = ["".join(rng.choice(list(letters), int(n)))
            for n in rng.integers(0, 300, 40)]
    assert _outcome(profiling.search_stats, pt.Database(seqs), *bounds) == \
        _outcome(ref_profiling.search_stats, po.Database(seqs), *bounds)


def test_trace_writes_a_chrome_trace(tmp_path):
    logdir = tmp_path / "trace"
    with profiling.trace(str(logdir)):
        pt.Aligner(device="cpu").align("ACCTCG", pt.Database(["AACCGCTG"]))
    events = json.loads((logdir / "trace.json").read_text())["traceEvents"]
    assert events


def test_device_info_without_cuda(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    info = pt._device_info()
    ref = po._device_info()
    assert set(info) == set(ref) == {"backend", "devices", "n_devices",
                                     "engines"}
    assert info["backend"] == "cpu"
    assert info["devices"] == [] and info["n_devices"] == 0
    engines = info["engines"]
    assert set(engines) == {"cuda", "plain", "native_encoder"}
    assert engines["cuda"]["available"] is False
    assert list(engines["cuda"]["kernels"]) == list(_cuda.KERNELS)
    for state in engines["cuda"]["kernels"].values():
        assert set(state) == {"built", "build_seconds"}
    assert engines["cuda"]["max_query_len"] == ragged.RAGGED_MAX_QPAD_STRIP
    assert engines["cuda"]["long_queries"] == \
        ref["engines"]["pallas"]["long_queries"]
    assert engines["plain"] == {"available": True}
    assert engines["native_encoder"] == {"available": True}
    json.dumps(info)


def _stub_functions(path):
    """``{name: [parameter names]}`` of a stub's functions, methods as
    ``Class.name``."""
    out = {}

    def visit(body, prefix):
        for node in body:
            if isinstance(node, ast.ClassDef):
                out[prefix + node.name] = None
                visit(node.body, f"{prefix}{node.name}.")
            elif isinstance(node, ast.FunctionDef) and not any(
                isinstance(d, ast.Name) and d.id == "overload"
                for d in node.decorator_list
            ):
                a = node.args
                out[prefix + node.name] = [
                    x.arg for x in a.posonlyargs + a.args + a.kwonlyargs
                    if x.arg not in ("self", "cls")
                ]
            elif isinstance(node, ast.AnnAssign):
                out[prefix + node.target.id] = None

    visit(ast.parse(path.read_text()).body, "")
    return out


@pytest.mark.parametrize("stub,module", [
    ("__init__.pyi", pt), ("parallel/__init__.pyi", parallel),
])
def test_stubs_match_signatures(stub, module):
    stubs = _stub_functions(REPO / "pyopal_tpu_torch" / stub)
    names = [n for n in module.__all__ if n != "__version__"]
    assert set(names) <= set(stubs)
    for name, params in stubs.items():
        obj = module
        for part in name.split("."):
            obj = getattr(obj, part, None)
        # instance attributes and the stub's own helper types
        # (``_SharedMutex``) are not attributes of the module
        assert obj is not None or "." in name or name.startswith("_"), name
        # attributes, properties and classes (a C type keeps no
        # signature) are checked by name only
        if params is None or not callable(obj) or inspect.isclass(obj):
            continue
        sig = [p.name for p in inspect.signature(obj).parameters.values()
               if p.kind not in (p.VAR_POSITIONAL, p.VAR_KEYWORD)
               and p.name not in ("self", "cls")]
        if sig or not params:
            assert params == sig, name


def test_stubs_ship_with_the_package():
    for path in ("py.typed", "__init__.pyi", "parallel/__init__.pyi"):
        assert (REPO / "pyopal_tpu_torch" / path).is_file()


def test_port_tests_pin_torch_threads():
    """This worker runs torch on its share of the CPU, and every port test
    file imports `_torch_cpu`, the module that pins it, at its top."""
    workers = max(1, int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1")))
    assert torch.get_num_threads() <= max(1, os.cpu_count() // workers)
    files = sorted((REPO / "tests").glob("test_torch_*.py"))
    assert len(files) > 10
    for path in files:
        tree = ast.parse(path.read_text(), str(path))
        names = {alias.name for node in tree.body
                 if isinstance(node, ast.Import) for alias in node.names}
        assert "_torch_cpu" in names, path.name
