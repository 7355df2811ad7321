"""The port's FASTA and database I/O (`pyopal_tpu_torch.io`) against
`pyopal_tpu.io`.

Both scanners of the port (the C one of ``native/encoder.c`` and
``_parse_fasta_py``) must read every FASTA input as the reference reads
it; archives written by either package must load in the other; and
`load_database` must refuse what the reference refuses, with the same
exception types and messages.
"""

import numpy as np
import pytest

import pyopal_tpu as po
import pyopal_tpu_torch as pt
from pyopal_tpu import io as ref_io
from pyopal_tpu_torch import io
import _torch_cpu  # noqa: F401  (torch threads: a worker's share)

FASTA = b"""\
>seq1 first sequence
GATTACA
>seq2
TTTT
TTAA
>seq3 another one
ACGTACGTACGT
"""

#: the adversarial inputs of tests/test_io.py's TestFastaEdgeCases
EDGE_CASES = {
    "crlf": b">a r\r\nGAT\r\nTACA\r\n>b\r\nTTTT\r\n",
    "no_trailing_newline": b">a\nGATT\n>b\nACGT",
    "empty_record": b">a\nGATT\n>empty\n>b\nACGT\n",
    "blank_lines": b">a\n\nGAT\n\nTACA\n\n>b\nTT\n",
    "bare_gt_header": b">\nGATT\n>b x\nACGT\n",
    "tab_header": b">a\tdescription here\nGATT\n",
    "leading_junk_ignored": b"; comment\n>a\nGATT\n",
    "spaces_in_seq": b">a\nGAT TACA\n",
    "empty_input": b"",
    "header_only": b">lonely header\n",
    "mid_line_gt": b">a\nGA>b\nTT\n",
    "the_file": FASTA,
}


def _outcome(fn, *args):
    try:
        return "value", fn(*args)
    except Exception as err:  # the outcome compared is the exception
        return type(err).__name__, str(err)


def _read(read_fasta, data, alphabet):
    names, db = read_fasta(data, alphabet=alphabet)
    return names, [db.get_encoded(i).tobytes() for i in range(len(db))]


def _port_read(scanner):
    """The port's `read_fasta` through one scanner, as ``(names,
    encoded bytes)``."""
    def read(data, alphabet):
        if scanner == "c":
            assert io._native_encoder is not None
            return _read(pt.read_fasta, data, alphabet)
        names, seqs = io._parse_fasta_py(data, pt.Alphabet(alphabet))
        return names, [s.tobytes() for s in seqs]
    return read


@pytest.mark.parametrize("case", sorted(EDGE_CASES))
@pytest.mark.parametrize("scanner", ["c", "python"])
def test_fasta_edge_cases_match_reference(case, scanner):
    data = EDGE_CASES[case]
    want = _read(po.read_fasta, data, "ACGT")
    assert _port_read(scanner)(data, "ACGT") == want


@pytest.mark.parametrize("scanner", ["c", "python"])
def test_fasta_refusals_match_reference(scanner):
    read = _port_read(scanner)
    for data, letters in [(b">a\nGATX\n", "ACGT"), (b">a\nAC-GT\n", "ACGT"),
                          (b">a\nGA\xffT\n", "ACGT"), (b">a\nGA*T\n", "ACGT"),
                          (b">a\nGAUT\n>b\nG-\n", "ACGT*")]:
        assert _outcome(read, data, letters) == _outcome(
            _read, po.read_fasta, data, letters), data


@pytest.mark.parametrize("scanner", ["c", "python"])
def test_fasta_stop_codon_matches_reference(scanner):
    data = b">a\nMKV*\n>b desc\nAC*GT\n"
    letters = pt.Database._DEFAULT_ALPHABET.letters
    got = _port_read(scanner)(data, letters)
    assert got == _read(po.read_fasta, data, letters)
    assert got[0] == ["a", "b"]


def test_read_fasta_from_a_file(tmp_path):
    path = tmp_path / "db.fasta"
    path.write_bytes(FASTA)
    names, db = pt.read_fasta(str(path), alphabet="ACGT")
    assert names == ["seq1", "seq2", "seq3"]
    assert list(db) == ["GATTACA", "TTTTTTAA", "ACGTACGTACGT"]
    assert db.alphabet == pt.Alphabet("ACGT")
    _, default = pt.read_fasta(path)
    assert default.alphabet.letters == "ARNDCQEGHILKMFPSTWYVBZX*"


ROUND_TRIPS = {
    "names": (["GATTACA", "TTTT", "ACGTACGT"], "ACGT", ["a", "b", "c"]),
    "no_names": (["ACCTG", "TTGA", ""], None, None),
    "empty": ([], "ACGT", None),
}


@pytest.mark.parametrize("case", sorted(ROUND_TRIPS))
@pytest.mark.parametrize("suffix", [".npz", ""])
@pytest.mark.parametrize("writer", ["port", "reference"])
def test_save_load_round_trip_across_packages(case, suffix, writer, tmp_path):
    seqs, letters, names = ROUND_TRIPS[case]
    path = str(tmp_path / f"db{suffix}")
    if writer == "port":
        pt.save_database(path, pt.Database(seqs, alphabet=letters), names)
    else:
        po.save_database(path, po.Database(seqs, alphabet=letters), names)
    ref_names, ref_db = po.load_database(path)
    got_names, got_db = pt.load_database(path)
    assert got_names == ref_names == names
    assert list(got_db) == list(ref_db) == seqs
    assert got_db.alphabet.letters == ref_db.alphabet.letters
    with np.load(path if suffix else path + ".npz") as f:
        assert set(f.files) == {"payload", "lengths", "alphabet"} | (
            {"names"} if names is not None else set())
        if names is not None:
            assert f["names"].dtype.kind == "U"  # never a pickled object


def _archive(path, payload, lengths, names=None):
    kwargs = dict(
        payload=np.asarray(payload, np.uint8),
        lengths=np.asarray(lengths, np.int64),
        alphabet=np.frombuffer(b"ACGT", dtype=np.uint8),
    )
    if names is not None:
        kwargs["names"] = names
    np.savez(path, **kwargs)


REFUSALS = {
    "pickled_names": ([], [], np.asarray(["x", None], dtype=object)),
    "negative_length": ([0, 1], [3, -1]),
    "length_mismatch": ([0, 1, 2], [2, 4]),
    "out_of_alphabet": ([0, 1, 7], [3]),
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_load_database_refusals_match_reference(case, tmp_path):
    path = str(tmp_path / f"{case}.npz")
    _archive(path, *REFUSALS[case])
    want = _outcome(po.load_database, path)
    assert want[0] == "ValueError"
    assert _outcome(pt.load_database, path) == want


def test_search_of_a_fasta_database_equals_in_memory(tmp_path):
    rng = np.random.default_rng(11)
    letters = "ARNDCQEGHILKMFPSTWYV"
    seqs = ["".join(rng.choice(list(letters), int(n)))
            for n in rng.integers(1, 90, 40)]
    # line-wrapped at 60 like a real FASTA file, one record empty
    fasta = b"".join(
        b">t%d desc\n" % i + b"\n".join(
            s[j:j + 60].encode() for j in range(0, len(s), 60)) + b"\n"
        for i, s in enumerate(seqs + [""]))
    names, db = pt.read_fasta(fasta)
    assert names == [f"t{i}" for i in range(41)]
    pt.save_database(tmp_path / "db", db, names)
    _, loaded = pt.load_database(str(tmp_path / "db"))
    queries = [seqs[3][:40], seqs[17], "MKVLAAGIW"]
    aligner = pt.Aligner(device="cpu")
    memory = pt.Database(seqs + [""])
    want = aligner.align_arrays(queries, memory, mode="end")
    for search_db in (db, loaded):
        got = aligner.align_arrays(queries, search_db, mode="end")
        for key in ("scores", "query_ends", "target_ends"):
            np.testing.assert_array_equal(got[key], want[key])
    hits = aligner.align(queries[0], loaded, mode="end")
    assert [(h.score, h.query_end, h.target_end) for h in hits] == [
        tuple(int(want[k][0, i]) for k in ("scores", "query_ends",
                                          "target_ends"))
        for i in range(41)]
    assert type(hits[0]) is pt.EndResult


def test_fasta_database_golden_self_hit():
    names, db = pt.read_fasta(FASTA, alphabet="ACGT")
    m = pt.ScoringMatrix.from_match_mismatch(2, -1, "ACGT")
    hits = pt.Aligner(m, gap_open=2, gap_extend=1, device="cpu").align(
        "GATTACA", db)
    assert hits[0].score == 14  # perfect self hit
    assert ref_io._native_encoder is not None  # both scanners were C
