"""Ordinal encoding of biological sequences.

Port of ``pyopal_tpu/alphabet.py``, with the port's own C codec
(``native/encoder.c``) as its fast path.  Original notes:
TPU-native re-design of the reference ``Alphabet`` class
(upstream PyOpal ``src/pyopal/lib.pyx:186-332``): same public semantics
(<=32 symbols, ``*`` wildcard, uppercase-only validation, 256-entry
lookup table), but the encode/decode hot path is vectorized with numpy
LUT indexing (optionally accelerated by the bundled C extension) and the
encoded representation is a ``numpy.uint8`` array ready for device
transfer and Pallas kernels.
"""

from __future__ import annotations

import numpy as np

#: Maximum number of symbols in an alphabet.  Mirrors the reference limit
#: (``lib.pxd:28-32``) which is implied by SIMD lane indexing; on TPU the
#: limit is implied by the one-hot profile matmul contraction dimension.
MAX_ALPHABET_SIZE = 32

# ASCII alpha lookup used to mirror the reference's ``isalpha`` check
# (``lib.pyx:264-266``): input characters must be ASCII letters.
_IS_ALPHA = np.zeros(256, dtype=bool)
for _c in range(ord("A"), ord("Z") + 1):
    _IS_ALPHA[_c] = True
for _c in range(ord("a"), ord("z") + 1):
    _IS_ALPHA[_c] = True

try:  # optional native fast path (see native/encoder.c)
    from .native import _encoder as _native_encoder
except ImportError:  # pragma: no cover - extension not built
    _native_encoder = None


class Alphabet:
    """A fixed symbol set mapping letters to ordinal codes.

    Reference parity: ``pyopal.Alphabet`` (``lib.pyx:186-332``).

    Example:
        >>> alphabet = Alphabet("ACGT")
        >>> alphabet.encode("GATACA")
        b'\\x02\\x00\\x03\\x00\\x01\\x00'

    """

    _DEFAULT_LETTERS = "ARNDCQEGHILKMFPSTWYVBZX*"

    __slots__ = ("letters", "length", "_unknown", "_letters", "_ahash")

    def __init__(self, letters: str = _DEFAULT_LETTERS) -> None:
        if not isinstance(letters, str):
            raise TypeError(f"expected str, got {type(letters).__name__}")
        if len(letters) != len(set(letters)):
            raise ValueError("duplicate symbols in alphabet letters")
        if any(x != "*" and not x.isupper() for x in letters):
            raise ValueError(
                "alphabet must only contain uppercase characters or wildcard"
            )
        if any(x != "*" and not ("A" <= x <= "Z") for x in letters):
            # mirror the ASCII-only restriction of the reference
            raise ValueError(
                "alphabet must only contain uppercase characters or wildcard"
            )
        if len(letters) > MAX_ALPHABET_SIZE:
            raise ValueError("Cannot use alphabet of more than 32 symbols")

        self.letters = letters
        self.length = len(letters)
        self._unknown = letters.find("*")

        # raw letter table, zero padded to MAX_ALPHABET_SIZE
        self._letters = np.zeros(MAX_ALPHABET_SIZE, dtype=np.uint8)
        raw = letters.encode("ascii")
        self._letters[: len(raw)] = np.frombuffer(raw, dtype=np.uint8)

        # 256-entry ASCII -> ordinal hash; default is the wildcard index
        # (or -1 when the alphabet has no wildcard), per lib.pyx:219-221.
        self._ahash = np.full(256, self._unknown, dtype=np.int8)
        for i, x in enumerate(raw):
            self._ahash[x] = i

    # --- Magic methods -----------------------------------------------------

    def __len__(self) -> int:
        return self.length

    def __contains__(self, item: object) -> bool:
        return item in self.letters

    def __getitem__(self, index: int) -> str:
        index_ = operator_index(index)
        if index_ < 0:
            index_ += self.length
        if index_ < 0 or index_ >= self.length:
            raise IndexError(index)
        return self.letters[index_]

    def __reduce__(self):
        return type(self), (self.letters,)

    def __repr__(self) -> str:
        if self.letters == self._DEFAULT_LETTERS:
            return f"{type(self).__name__}()"
        return f"{type(self).__name__}({self.letters!r})"

    def __str__(self) -> str:
        return self.letters

    def __eq__(self, item: object) -> bool:
        if isinstance(item, str):
            return self.letters == item
        elif isinstance(item, Alphabet):
            return self.letters == item.letters
        else:
            return False

    def __hash__(self) -> int:
        # hash like the letters string: __eq__ compares equal to plain
        # strings (reference parity), and the eq/hash contract then
        # requires equal hashes — {"ACGT": 1}[Alphabet("ACGT")] works
        return hash(self.letters)

    # --- Encoding ----------------------------------------------------------

    def encode_into(self, sequence, encoded) -> None:
        """Write the ordinal codes of ``sequence`` into ``buffer``."""
        seq = np.frombuffer(memoryview(sequence), dtype=np.uint8)
        out = np.frombuffer(memoryview(encoded), dtype=np.uint8)
        if seq.shape[0] != out.shape[0]:
            raise ValueError("Buffers do not have the same dimensions")
        if (
            _native_encoder is not None
            and seq.flags["C_CONTIGUOUS"]
            and out.flags["C_CONTIGUOUS"]
        ):
            # zero-copy native path: validates and writes straight
            # into the caller's buffer
            _native_encoder.encode_into(seq, out, self._ahash)
            return
        out[: seq.shape[0]] = self._encode_array(seq)

    def decode_into(self, encoded, sequence) -> None:
        """Write the letters for the ordinal codes of ``sequence`` into ``buffer``."""
        enc = np.frombuffer(memoryview(encoded), dtype=np.uint8)
        out = np.frombuffer(memoryview(sequence), dtype=np.uint8)
        if enc.shape[0] != out.shape[0]:
            raise ValueError("Buffers do not have the same dimensions")
        out[: enc.shape[0]] = self._decode_array(enc)

    def _encode_array(self, seq: np.ndarray) -> np.ndarray:
        """Vectorized ASCII->ordinal encoding of a ``uint8`` array.

        Error semantics follow the reference (``lib.pyx:262-270``):
        non-ASCII-alpha input raises, and characters absent from the
        alphabet either map to the wildcard or raise when there is none.
        """
        if _native_encoder is not None and seq.flags["C_CONTIGUOUS"]:
            encoded = _native_encoder.encode(seq, self._ahash)
            return np.frombuffer(encoded, dtype=np.uint8)
        codes = self._ahash[seq]
        bad_mask = ~_IS_ALPHA[seq]
        if self._unknown < 0:
            bad_mask |= codes < 0
        if seq.size and bad_mask.any():
            # classify the FIRST offending character in sequence order,
            # exactly like the native extension's (and the reference's)
            # sequential scan — lib.pyx:262-270
            i = int(np.argmax(bad_mask))
            bad = int(seq[i])
            if not _IS_ALPHA[bad]:
                raise ValueError(f"character outside ASCII range: {bad!r}")
            raise ValueError(
                f"non-alphabet character in sequence: {chr(bad)!r}"
            )
        return codes.astype(np.uint8)

    def _decode_array(self, enc: np.ndarray) -> np.ndarray:
        if enc.size and (enc >= self.length).any():
            bad = int(enc[enc >= self.length][0])
            raise ValueError(f"invalid index in encoded sequence: {bad!r}")
        return self._letters[enc]

    def encode(self, sequence) -> bytes:
        r"""Return ``sequence`` as `bytes` of ordinal codes.

        Arguments:
            sequence (`str` or byte-like object): The sequence to encode.

        Raises:
            `ValueError`: When the sequence contains invalid characters, or
                unknown sequence characters while the alphabet contains no
                wildcard character.

        Example:
            >>> alphabet = Alphabet("ACGT")
            >>> alphabet.encode("GATACA")
            b'\x02\x00\x03\x00\x01\x00'

        """
        if isinstance(sequence, str):
            sequence = sequence.encode("ascii")
        seq = np.frombuffer(memoryview(sequence), dtype=np.uint8)
        return self._encode_array(seq).tobytes()

    def decode(self, encoded) -> str:
        r"""Return the letters (`str`) for `bytes` of ordinal codes.

        Example:
            >>> alphabet = Alphabet("ACGT")
            >>> alphabet.decode(bytearray([2, 0, 3, 0, 1, 0]))
            'GATACA'

        """
        enc = np.frombuffer(memoryview(encoded), dtype=np.uint8)
        return self._decode_array(enc).tobytes().decode("ascii")


def operator_index(index) -> int:
    """``operator.index`` with the reference's error type (TypeError)."""
    import operator

    return operator.index(index)
