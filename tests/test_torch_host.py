"""The port's host layer against `pyopal_tpu`: tables, codec, layout.

Every table, encoding, error message and flat layout of
`pyopal_tpu_torch` must equal the reference's exactly; the port must
import neither JAX nor `pyopal_tpu`.
"""

import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import pyopal_tpu as po
import pyopal_tpu_torch as pt
from pyopal_tpu.matrices import _TABLES
from pyopal_tpu.ops import packing as ref_packing
from pyopal_tpu_torch.ops import packing
import _torch_cpu  # torch threads: a worker's share, also for subprocesses

REPO = Path(__file__).resolve().parent.parent

MATRIX_NAMES = sorted(_TABLES) + [
    "PAM10", "PAM30", "PAM70", "PAM120", "PAM250", "PAM500", "PAM40/3",
    "VTML10", "VTML80", "VTML120", "VTML200",
]


@pytest.mark.parametrize("name", MATRIX_NAMES)
def test_from_name_tables_equal(name):
    ref = po.ScoringMatrix.from_name(name)
    got = pt.ScoringMatrix.from_name(name)
    assert got.alphabet == ref.alphabet
    assert got.name == ref.name
    np.testing.assert_array_equal(got.data, ref.data)


def _error(fn, *args):
    with pytest.raises(Exception) as info:
        fn(*args)
    return type(info.value).__name__, str(info.value)


@pytest.mark.parametrize(
    "name", ["PFASUM60", "GONNET", "MIQS", "BENNER74", "JOHNSON", "NOPE"]
)
def test_from_name_errors_equal(name):
    assert _error(pt.ScoringMatrix.from_name, name) == _error(
        po.ScoringMatrix.from_name, name
    )


def test_encode_decode_round_trip_equal():
    rng = np.random.default_rng(7)
    for letters in ("ARNDCQEGHILKMFPSTWYVBZX*", "ACGT", "AB*"):
        ref, got = po.Alphabet(letters), pt.Alphabet(letters)
        plain = letters.replace("*", "")
        for n in (0, 1, 17, 300):
            seq = "".join(rng.choice(list(plain), n))
            enc = got.encode(seq)
            assert enc == ref.encode(seq)
            assert got.decode(enc) == ref.decode(enc) == seq
    # unknown letters map to the wildcard where there is one
    assert pt.Alphabet("AB*").encode("AZB") == po.Alphabet("AB*").encode("AZB")


@pytest.mark.parametrize(
    "call",
    [
        lambda m: m.Alphabet("ACGT").encode("ACGU"),
        lambda m: m.Alphabet("ACGT").encode("AC-T"),
        lambda m: m.Alphabet("ACGT").decode(bytes([0, 9])),
        lambda m: m.Alphabet("AAC"),
        lambda m: m.Alphabet("acgt"),
        lambda m: m.Alphabet("A" * 33),
        lambda m: m.Alphabet(5),
        lambda m: m.Database(["ACGU"], alphabet="ACGT"),
        lambda m: m.Database(["AC"])[5],
        lambda m: m.ScoringMatrix([[1, 2, 3]], "AB"),
    ],
)
def test_error_types_and_messages_equal(call):
    assert _error(call, pt) == _error(call, po)


def test_database_surface_equal():
    seqs = ["ATGC", "TTCA", "", "GGTGA"]
    ref, got = po.Database(seqs), pt.Database(seqs)
    assert list(got) == list(ref)
    assert got.lengths == ref.lengths
    assert got.total_length == ref.total_length
    assert list(got.extract([3, 0])) == list(ref.extract([3, 0]))
    mask = [True, False, True, True]
    assert list(got.mask(mask)) == list(ref.mask(mask))


@pytest.mark.parametrize("seed", range(4))
def test_flat_layout_and_payload_equal(seed):
    rng = np.random.default_rng(seed)
    lengths = [0, 1, 63, 64, 65, 127, 128, 129] + list(
        rng.integers(0, 300, int(rng.integers(1, 300)))
    )
    rng.shuffle(lengths)
    seqs = [rng.integers(0, 24, int(n)).astype(np.uint8) for n in lengths]
    for lanes in (128, 256, 512):
        ref = ref_packing.flat_layout(lengths, lanes=lanes)
        got = packing.flat_layout(lengths, lanes=lanes)
        for field in (
            "n_targets", "n_blocks", "total_rows", "blocks", "t_pads",
            "lanes", "chunk",
        ):
            assert getattr(got, field) == getattr(ref, field), field
        for field in (
            "lengths", "indices", "block_of_step", "chunk_of_step",
            "last_of_step", "inv_pos",
        ):
            np.testing.assert_array_equal(
                getattr(got, field), getattr(ref, field), err_msg=field
            )
        np.testing.assert_array_equal(
            packing.fill_flat_payload(got, seqs),
            ref_packing.fill_flat_payload(ref, seqs),
        )


def test_convert_builds_equal_state():
    from pyopal_tpu_torch import convert

    ref_m = po.ScoringMatrix.from_name("BLOSUM62")
    m = convert.scoring_matrix_from_numpy(ref_m.alphabet, ref_m.data)
    assert m == pt.ScoringMatrix.from_name("BLOSUM62")
    ref_db = po.Database(["ACDE", "", "WYV"])
    enc = [ref_db.get_encoded(i) for i in range(len(ref_db))]
    db = convert.database_from_numpy(ref_db.alphabet.letters, enc)
    assert list(db) == list(ref_db)
    with pytest.raises(ValueError):
        convert.database_from_numpy("AC", [np.array([0, 2])])


def test_import_leaves_jax_out():
    code = (
        "import sys, pyopal_tpu_torch, pyopal_tpu_torch.ops.traceback, "
        "pyopal_tpu_torch.parallel; print('jax' in sys.modules)"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True,
        text=True, check=True, env=_torch_cpu.subprocess_env(),
    )
    assert out.stdout.strip() == "False"


def _port_files():
    files = sorted((REPO / "pyopal_tpu_torch").rglob("*.py"))
    return files + [REPO / "chip_smoke.py"]


def test_port_imports_neither_jax_nor_reference():
    files = _port_files()
    assert len(files) > 10 and files[-1].exists()
    for path in files:
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            for name in names:
                top = name.split(".")[0]
                assert top not in ("jax", "pyopal_tpu"), (path, name)


def test_aligner_without_device_needs_cuda(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pt.Aligner()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        list(pt.align("ACGT", ["ACGT"]))
    assert pt.Aligner(device="cpu").device.type == "cpu"
