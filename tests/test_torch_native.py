"""The port's C extensions (``pyopal_tpu_torch/native``) against the
JAX package's.

The result types and bulk builders of ``native/results.c``, the codec of
``native/encoder.c`` and the pure-Python fallbacks of ``results.py`` and
``alphabet.py`` must give the reference's values, or its exception types
and messages, case for case; the extensions must be built and active,
and a pickled result must load in a process that never imports JAX.
"""

import pickle
import re
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest

import pyopal_tpu as po
import pyopal_tpu_torch as pt
from pyopal_tpu.native import _encoder as ref_encoder
from pyopal_tpu_torch import alphabet, io, native, results
from pyopal_tpu_torch.native import _encoder
import _torch_cpu  # torch threads: a worker's share, also for subprocesses

REPO = Path(__file__).resolve().parent.parent


def test_extensions_built_and_active():
    assert native.ensure_built(), native._missing_extensions()
    assert native._missing_extensions() == []
    for name in ("_encoder", "_results"):
        module = sys.modules[f"pyopal_tpu_torch.native.{name}"]
        # a checkout loads the libraries built from its own sources
        assert Path(module.__file__) == native._library_path(name)
        assert getattr(native, name) is module
    for cls in (results.ScoreResult, results.EndResult):
        assert cls.__module__ == "pyopal_tpu_torch.native._results"
    assert pt.ScoreResult is results.ScoreResult
    assert pt.EndResult is results.EndResult
    assert issubclass(pt.FullResult, results.EndResult)
    assert alphabet._native_encoder is _encoder
    assert io._native_encoder is _encoder


def test_search_returns_native_objects():
    hits = pt.Aligner(device="cpu").align(
        "ACCTCG", pt.Database(["AACCGCTG"]), mode="end"
    )
    assert type(hits[0]).__module__ == "pyopal_tpu_torch.native._results"
    assert (hits[0].score, hits[0].query_end, hits[0].target_end) == (47, 5, 7)


def test_c_sources_name_no_reference_module():
    sources = sorted((REPO / "pyopal_tpu_torch" / "native").glob("*.c"))
    assert [p.name for p in sources] == ["encoder.c", "results.c"]
    for path in sources:
        text = path.read_text()
        assert not re.search(r"\bpyopal_tpu\.", text), path
    text = (REPO / "pyopal_tpu_torch" / "native" / "results.c").read_text()
    for name in ("ScoreResult", "EndResult"):
        assert f'"pyopal_tpu_torch.native._results.{name}"' in text


#: calls on (ScoreResult, EndResult): the fault cases of the Python
#: classes the port had before its C types, and the types' protocol
CASES = {
    "negative_index": lambda S, E: S(-1, 5).target_index,
    "negative_index_end": lambda S, E: repr(E(-1, 5, 0, 0)),
    "negative_index_eq_hash": lambda S, E: (
        S(-1, 5) == S(-1, 5), hash(E(-1, 5, 0, 0)) == hash((-1, 5, 0, 0))),
    "negative_index_pickle": lambda S, E: repr(
        pickle.loads(pickle.dumps(E(-1, 5, 0, 0)))),
    "float_score": lambda S, E: S(1, 5.0),
    "str_index": lambda S, E: S("1", 5),
    "float_index_end": lambda S, E: E(1.0, 5, 0, 0),
    "index_too_large": lambda S, E: S(2**63, 5),
    "index_too_small": lambda S, E: S(-(2**63) - 1, 5),
    "score_too_large": lambda S, E: S(1, 2**63),
    "both_too_large": lambda S, E: S(2**63, 2**63),
    "end_too_large": lambda S, E: E(1, 2, 2**63, 4),
    "range_limits": lambda S, E: repr(E(2**63 - 1, -(2**63), 2**63 - 1, -1)),
    "no_arguments": lambda S, E: S(),
    "three_arguments": lambda S, E: S(1, 5, 6),
    "three_keywords": lambda S, E: S(target_index=1, score=2, foo=3),
    "missing_by_keyword": lambda S, E: S(1, target_index=2),
    "score_only": lambda S, E: S(score=2),
    "keywords": lambda S, E: repr(S(score=2, target_index=1)),
    "end_no_arguments": lambda S, E: E(),
    "end_five_arguments": lambda S, E: E(1, 2, 3, 4, 5),
    "end_missing_target_end": lambda S, E: E(1, 2, query_end=3),
    "end_int_semantics": lambda S, E: repr(E(1, 2, 3.7, "4")),
    "end_none": lambda S, E: E(1, 2, None, 4),
    "end_nan": lambda S, E: E(1, 2, float("nan"), 0),
    "bool_fields": lambda S, E: repr(S(True, False)),
    "repr": lambda S, E: (repr(S(3, -47)), repr(E(0, 0, -1, -1))),
    "eq": lambda S, E: (S(1, 2) == S(1, 2), S(1, 2) != S(1, 3),
                        S(1, 2) == E(1, 2, 0, 0), E(1, 2, 3, 4) == E(1, 2, 3, 4),
                        E(1, 2, 3, 4) != E(1, 2, 3, 5), S(1, 2) == 12),
    "hash": lambda S, E: (hash(S(1, 2)) == hash((1, 2)),
                          hash(E(1, 2, 3, 4)) == hash((1, 2, 3, 4))),
    "pickle": lambda S, E: [
        (repr(x), pickle.loads(pickle.dumps(x)) == x)
        for x in (S(10, 30), E(2, 30, 10, 20))],
    "reduce": lambda S, E: (S(1, 2).__reduce__()[1],
                            E(1, 2, 3, 4).__reduce__()[1]),
    "subclass": lambda S, E: S.__subclasscheck__(E),
}


def _outcome(fn, *args):
    try:
        return "value", fn(*args)
    except Exception as err:  # the outcome compared is the exception
        return type(err).__name__, str(err)


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("types", ["c", "python"])
def test_result_types_match_reference(case, types, monkeypatch):
    fn = CASES[case]
    want = _outcome(fn, po.ScoreResult, po.EndResult)
    if types == "python":
        # the module as it stands where the extension did not build:
        # the public names are the Python classes (pickle finds them so)
        monkeypatch.setattr(results, "ScoreResult", results._PyScoreResult)
        monkeypatch.setattr(results, "EndResult", results._PyEndResult)
    got = _outcome(fn, results.ScoreResult, results.EndResult)
    assert got == want


def test_pickled_module_names_the_port():
    ref = type(pickle.loads(pickle.dumps(po.EndResult(1, 2, 3, 4))))
    got = type(pickle.loads(pickle.dumps(pt.EndResult(1, 2, 3, 4))))
    assert ref.__module__ == "pyopal_tpu.native._results"
    assert got.__module__ == "pyopal_tpu_torch.native._results"


def test_pickle_loads_in_a_fresh_process_without_jax():
    hits = [
        pt.ScoreResult(-1, 5),
        pt.EndResult(3, 47, 5, 7),
        pt.FullResult(0, 44, 5, 7, 0, 0, 6, 8, "IMMMXMIM"),
    ]
    code = (
        "import pickle, sys\n"
        "hits = pickle.loads(sys.stdin.buffer.read())\n"
        "print([type(h).__module__ for h in hits])\n"
        "print(repr(hits))\n"
        "print('jax' in sys.modules)\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, input=pickle.dumps(hits),
        capture_output=True, check=True, env=_torch_cpu.subprocess_env(),
    )
    modules, text, jax_loaded = out.stdout.decode().splitlines()
    assert modules == str([
        "pyopal_tpu_torch.native._results",
        "pyopal_tpu_torch.native._results",
        "pyopal_tpu_torch.results",
    ])
    assert text == repr(hits)
    assert jax_loaded == "False"


@pytest.mark.parametrize("builders", ["c", "python"])
def test_bulk_builders_match_reference(builders):
    rng = np.random.default_rng(3)
    scores, qe, te = (rng.integers(-5, 1000, 50).astype(np.int32)
                      for _ in range(3))
    if builders == "c":
        build_s, build_e = results.build_score_results, results.build_end_results
        types = (results.ScoreResult, results.EndResult)
    else:
        build_s = results._py_build_score_results
        build_e = results._py_build_end_results
        types = (results._PyScoreResult, results._PyEndResult)
    from pyopal_tpu import results as ref

    for got, want, cls in (
        (build_s(7, scores), ref.build_score_results(7, scores), types[0]),
        (build_e(7, scores, qe, te), ref.build_end_results(7, scores, qe, te),
         types[1]),
    ):
        assert [type(r) for r in got] == [cls] * 50
        assert [r.__reduce__()[1] for r in got] == [
            r.__reduce__()[1] for r in want]
        assert [repr(r) for r in got] == [repr(r) for r in want]


def test_c_builders_refuse_what_the_reference_refuses():
    from pyopal_tpu.native import _results as ref
    from pyopal_tpu_torch.native import _results as mine

    bad = [
        ("build_score_results", (0, b"abcd")),
        ("build_score_results", (0, np.zeros(3, np.int64))),
        ("build_end_results", (0, *(np.zeros(n, np.int32) for n in (3, 3, 2)))),
    ]
    for name, args in bad:
        assert _outcome(getattr(mine, name), *args) == _outcome(
            getattr(ref, name), *args)


ENCODE_INPUTS = [b"", b"GATACA", b"gataca", b"ANX", b"AC-GT", b"AC*GT",
                 b"A C", b"\xffA", b"ACGU"]


@pytest.mark.parametrize("letters", ["ACGT", "ACGT*", "ARNDCQEGHILKMFPSTWYVBZX*"])
def test_encoder_matches_reference(letters):
    table = po.Alphabet(letters)._ahash
    assert np.array_equal(pt.Alphabet(letters)._ahash, table)
    fasta = b">a x\nGAT\r\nTA\n>b\n" + b"\n".join(ENCODE_INPUTS) + b"\n"
    calls = [("parse_fasta", (fasta, table)), ("encode", (b"ACGT", b"x"))]
    for seq in ENCODE_INPUTS:
        calls.append(("encode", (seq, table)))
        calls.append(("encode_into", (seq, bytearray(len(seq)), table)))
    calls.append(("encode_into", (b"ACG", bytearray(2), table)))
    for name, args in calls:
        want = _outcome(getattr(ref_encoder, name), *args)
        dst = bytes(args[1]) if name == "encode_into" else None
        got = _outcome(getattr(_encoder, name), *args)
        assert got == want, (name, args)
        if name == "encode_into":
            assert bytes(args[1]) == dst  # the reference wrote it first


@pytest.mark.parametrize("path", ["c", "python"])
def test_alphabet_paths_match_reference(path, monkeypatch):
    if path == "python":
        monkeypatch.setattr(alphabet, "_native_encoder", None)
    for letters in ("ACGT", "ACGT*"):
        ref, got = po.Alphabet(letters), pt.Alphabet(letters)
        for seq in ENCODE_INPUTS + [memoryview(b"GATT"), bytearray(b"TTA")]:
            assert _outcome(got.encode, seq) == _outcome(ref.encode, seq)
            out_ref, out = bytearray(len(seq)), bytearray(len(seq))
            outcome = _outcome(got.encode_into, seq, out)
            assert outcome == _outcome(ref.encode_into, seq, out_ref)
            if path == "c" or outcome[0] == "value":
                # (where it refuses, the C scan has written the bytes
                # before the bad one, the Python path none)
                assert out == out_ref


def test_build_is_cached_and_serialized(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    lib = native._library_path("_encoder")
    assert lib.parent == tmp_path and lib.name.startswith("_encoder-")
    monkeypatch.setenv("PYOPAL_TPU_NO_BUILD", "1")
    with pytest.raises(ImportError):
        native._build("_encoder", True)
    monkeypatch.delenv("PYOPAL_TPU_NO_BUILD")
    built = []
    threads = [
        threading.Thread(target=lambda: built.append(
            native._build("_encoder", True)))
        for _ in range(3)
    ]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
        assert not t.is_alive()
    assert built == [lib] * 3
    assert sorted(p.name for p in tmp_path.iterdir()) == [".lock", lib.name]
