"""Database I/O: FASTA loading and the on-disk encoded-database format.

Port of ``pyopal_tpu/io.py``, with the port's own C scanner
(``native/encoder.c``).  Upstream PyOpal has no bundled loader (its docs
parse FASTA with external tools); for database search at scale the load
path is a real bottleneck, so this module provides:

- `read_fasta`: loading through the native C scanner
  (`pyopal_tpu_torch.native._encoder.parse_fasta`) with a pure-Python
  fallback that gives the same result byte for byte — parsing +
  ordinal encoding in one pass;
- `save_database` / `load_database`: an ``.npz`` on-disk format holding
  the already-encoded sequences, so multi-gigabyte databases are not
  re-parsed and re-encoded on every run.  The archive holds plain arrays
  only (names as fixed-width unicode, never pickled objects), and
  `load_database` refuses pickled names, corrupt lengths and codes
  outside the alphabet.
"""

from __future__ import annotations

import numpy as np

from .alphabet import _IS_ALPHA, Alphabet
from .database import Database

try:  # pragma: no cover - exercised when the extension is built
    from .native import _encoder as _native_encoder
except ImportError:
    _native_encoder = None


def read_fasta(path_or_data, alphabet=None):
    """Parse a FASTA file into ``(names, Database)``.

    Arguments:
        path_or_data: a filesystem path, or raw FASTA ``bytes``.
        alphabet: the `Alphabet` (or letters string) used for encoding;
            defaults to the protein alphabet.

    Returns:
        ``(names, database)`` — a list of record identifiers (first
        whitespace-delimited word of each header) and a `Database` of
        the encoded sequences, in file order.

    Example:
        >>> names, db = read_fasta(b">a first\\nMKV\\n>b\\nARN\\nDC\\n")
        >>> names, list(db)
        (['a', 'b'], ['MKV', 'ARNDC'])

    """
    if alphabet is None:
        alphabet = Database._DEFAULT_ALPHABET
    elif not isinstance(alphabet, Alphabet):
        alphabet = Alphabet(alphabet)

    if isinstance(path_or_data, (bytes, bytearray, memoryview)):
        data = bytes(path_or_data)
    else:
        with open(path_or_data, "rb") as f:
            data = f.read()

    if _native_encoder is not None:
        ids, encoded = _native_encoder.parse_fasta(data, alphabet._ahash)
        names = [i.decode("ascii", "replace") for i in ids]
        seqs = [np.frombuffer(e, dtype=np.uint8) for e in encoded]
    else:
        names, seqs = _parse_fasta_py(data, alphabet)

    db = Database(alphabet=alphabet)
    with db.lock.write:
        for s in seqs:
            s.setflags(write=False) if s.flags.owndata else None
            db._sequences.append(s)
        db._bump()
    return names, db


def _encode_fasta_seq(raw: bytes, alphabet: Alphabet) -> np.ndarray:
    """FASTA-lenient encode, matching the native scanner exactly:
    interior whitespace is skipped and ``*`` (stop codon) is accepted
    when the alphabet maps it — unlike the strict `Alphabet.encode`,
    which follows the reference's isalpha contract."""
    seq = np.frombuffer(raw, dtype=np.uint8)
    seq = seq[~np.isin(seq, (9, 10, 13, 32))]  # tab, LF, CR, space
    codes = np.asarray(alphabet._ahash)[seq]
    bad_mask = ~_IS_ALPHA[seq] & (seq != ord("*"))
    bad_mask |= codes < 0
    if seq.size and bad_mask.any():
        i = int(np.argmax(bad_mask))
        bad = int(seq[i])
        if not _IS_ALPHA[bad] and bad != ord("*"):
            raise ValueError(f"character outside ASCII range: {bad!r}")
        raise ValueError(
            f"non-alphabet character in sequence: {chr(bad)!r}"
        )
    return codes.astype(np.uint8)


def _parse_fasta_py(data: bytes, alphabet: Alphabet):
    """Pure-Python fallback mirroring the native scanner byte for
    byte: any ``>`` starts a record (even mid-line), the id is the
    header's first space/tab-delimited word WITHOUT stripping (so
    ``"> id"`` yields an empty id, like the C scanner), and the
    sequence region runs to the next ``>`` with tab/LF/CR/space
    skipped.  Results must not depend on whether the extension built.
    """
    names, seqs = [], []
    n = len(data)
    pos = 0
    while True:
        start = data.find(b">", pos)
        if start < 0:
            break
        p = start + 1
        # header: up to the first newline byte
        nl = data.find(b"\n", p)
        cr = data.find(b"\r", p)
        ends = [e for e in (nl, cr) if e != -1]
        hdr_end = min(ends) if ends else n
        header = data[p:hdr_end]
        sp = header.find(b" ")
        tb = header.find(b"\t")
        cut = min([c for c in (sp, tb) if c != -1], default=len(header))
        names.append(header[:cut].decode("ascii", "replace"))
        # sequence: every byte until the next '>'
        nxt = data.find(b">", hdr_end)
        seq_end = nxt if nxt >= 0 else n
        seqs.append(_encode_fasta_seq(data[hdr_end:seq_end], alphabet))
        pos = seq_end
    return names, seqs


def save_database(path, database: Database, names=None) -> None:
    """Serialize an encoded database to an ``.npz`` file.

    Stores the concatenated encoded payload + lengths + alphabet, so
    loading skips parsing and encoding entirely.
    """
    with database.lock.read:
        seqs = [database.get_encoded(i) for i in range(database.get_size())]
    lengths = np.array([s.shape[0] for s in seqs], dtype=np.int64)
    payload = (
        np.concatenate(seqs) if seqs else np.zeros(0, dtype=np.uint8)
    )
    kwargs = dict(
        payload=payload,
        lengths=lengths,
        alphabet=np.frombuffer(
            database.alphabet.letters.encode("ascii"), dtype=np.uint8
        ),
    )
    if names is not None:
        # fixed-width unicode, NOT dtype=object: object arrays force
        # pickle into the archive, which would make load_database an
        # arbitrary-code-execution vector for untrusted files
        kwargs["names"] = np.asarray([str(n) for n in names])
    np.savez_compressed(path, **kwargs)


def load_database(path):
    """Load a database saved with `save_database`.

    Returns ``(names, Database)``; ``names`` is `None` when the file
    was saved without them.
    """
    # mirror np.savez's implicit ".npz" suffix so the natural
    # round-trip load_database("db") after save_database("db") works
    import os

    p = os.fspath(path) if not hasattr(path, "read") else path
    if (
        isinstance(p, str)
        and not p.endswith(".npz")
        and not os.path.exists(p)
        and os.path.exists(p + ".npz")
    ):
        p = p + ".npz"
    # allow_pickle stays False (the numpy default): the format holds
    # only plain arrays, and pickled payloads in untrusted files would
    # execute arbitrary code on load
    with np.load(p) as f:
        payload = f["payload"]
        lengths = f["lengths"]
        letters = f["alphabet"].tobytes().decode("ascii")
        try:
            names = (
                [str(n) for n in f["names"]] if "names" in f else None
            )
        except ValueError as err:
            if "Object arrays" not in str(err):
                raise
            # archives written before the pickle-free format stored
            # names as an object array, which the safe loader refuses
            raise ValueError(
                f"{path!r} stores sequence names in the old pickled "
                "format, which is no longer loaded for security; "
                "regenerate the archive with save_database (e.g. parse "
                "the original FASTA with read_fasta and re-save)"
            ) from err

    if lengths.size and (lengths < 0).any():
        raise ValueError(f"{path!r}: corrupt archive (negative length)")
    if int(lengths.sum(initial=0)) != int(payload.shape[0]):
        raise ValueError(
            f"{path!r}: corrupt archive (payload holds "
            f"{payload.shape[0]} residues but lengths sum to "
            f"{int(lengths.sum(initial=0))})"
        )
    if payload.size and int(payload.max()) >= len(letters):
        # out-of-range codes would not fail loudly downstream: the
        # kernels would score them from the profile's padding columns,
        # silently corrupting results instead of raising
        raise ValueError(
            f"{path!r}: corrupt archive (encoded symbol "
            f"{int(payload.max())} outside the {len(letters)}-letter "
            f"alphabet)"
        )
    db = Database(alphabet=letters)
    offsets = np.concatenate([[0], np.cumsum(lengths)])
    with db.lock.write:
        for i in range(lengths.shape[0]):
            seq = payload[offsets[i] : offsets[i + 1]]
            seq.setflags(write=False)
            db._sequences.append(seq)
        db._bump()
    return names, db
