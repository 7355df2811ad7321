"""Sequence databases: host staging store + device-packed layout cache.

Port of ``pyopal_tpu/database.py``: `SharedMutex`, `BaseDatabase` and
`Database` unchanged.  The packed layouts memoized in ``_pack_cache``
are the port's flat packs (`pyopal_tpu_torch.ops.packing`); their
device tensors are cached on each pack per device.

TPU-native re-design of the reference containers
(upstream PyOpal ``src/pyopal/lib.pyx:337-778``).  The reference stores
encoded sequences as C++ ``shared_ptr`` payloads with zero-copy
subsetting; here each sequence is an immutable ``numpy.uint8`` array and
subsetting (`mask` / `extract` / slicing) shares the arrays without
copying.  A read/write lock mirrors the reference ``SharedMutex``
semantics (``lib.pyx:153-181``) so the database can be mutated from one
thread while searches run in others.

On top of the staging store, `Database` memoizes the *packed device
layout* (length-bucketed, padded ``[T_pad, LANES]`` blocks — see
``pyopal_tpu_torch.ops.packing``) keyed by a mutation version counter, so
repeated searches against an unchanged database skip re-packing and
re-uploading to device memory.
"""

from __future__ import annotations

import threading

import numpy as np

from .alphabet import Alphabet


class SharedMutex:
    """A read/write lock with ``.read`` / ``.write`` context managers.

    Python equivalent of the C++17 ``std::shared_mutex`` wrapper of the
    reference (``lib.pyx:153-181``): multiple concurrent readers, one
    exclusive writer.

    Like ``std::shared_mutex``, acquisition is **non-reentrant**: a
    thread already holding the shared lock must not re-acquire it
    (e.g. calling ``db.lengths`` or ``db[i]`` inside its own
    ``with db.lock.read:`` block) — once a writer queues, the nested
    reader waits for the writer while the writer waits for the
    outer reader to drain, deadlocking both.  Database accessors take
    the lock themselves, so user code rarely needs to.
    """

    def __init__(self) -> None:
        self._cond = threading.Condition(threading.Lock())
        self._readers = 0
        self._writer = False
        self._writers_waiting = 0
        self.read = ReadLock(self)
        self.write = WriteLock(self)

    # low-level ops ---------------------------------------------------------

    def lock_shared(self) -> None:
        with self._cond:
            # writer preference: new readers also yield to QUEUED
            # writers, otherwise a continuous stream of overlapping
            # searches starves mutation forever
            while self._writer or self._writers_waiting:
                self._cond.wait()
            self._readers += 1

    def unlock_shared(self) -> None:
        with self._cond:
            self._readers -= 1
            if self._readers == 0:
                self._cond.notify_all()

    def lock(self) -> None:
        with self._cond:
            self._writers_waiting += 1
            try:
                while self._writer or self._readers:
                    self._cond.wait()
            finally:
                self._writers_waiting -= 1
            self._writer = True

    def unlock(self) -> None:
        with self._cond:
            self._writer = False
            self._cond.notify_all()


class ReadLock:
    def __init__(self, owner: SharedMutex) -> None:
        self.owner = owner

    def __enter__(self):
        self.owner.lock_shared()
        return self

    def __exit__(self, exc_type, exc_value, traceback):
        self.owner.unlock_shared()


class WriteLock:
    def __init__(self, owner: SharedMutex) -> None:
        self.owner = owner

    def __enter__(self):
        self.owner.lock()
        return self

    def __exit__(self, exc_type, exc_value, traceback):
        self.owner.unlock()


class BaseDatabase:
    """Abstract view over a collection of encoded target sequences.

    Subclasses must implement `get_size`, `get_lengths` and
    `get_encoded` to expose encoded sequences to `Aligner.align`
    (reference interface at ``lib.pyx:337-466``).

    Attributes:
        alphabet (`~pyopal_tpu.Alphabet`): Alphabet every stored
            sequence is encoded with.
        lock (`~pyopal_tpu.database.SharedMutex`): Guards mutation
            against concurrent searches (readers share, writers
            exclude).

    """

    _DEFAULT_ALPHABET = Alphabet()

    def __init__(self, sequences=(), alphabet=None) -> None:
        self.lock = SharedMutex()
        if alphabet is None:
            self.alphabet = self._DEFAULT_ALPHABET
        elif isinstance(alphabet, Alphabet):
            self.alphabet = alphabet
        else:
            self.alphabet = Alphabet(alphabet)
        if sequences:
            raise TypeError("cannot create a `BaseDatabase` with sequences")

    # --- Database interface (override in subclasses) -----------------------

    def get_size(self) -> int:
        return 0

    def get_lengths(self):
        raise NotImplementedError("BaseDatabase.get_lengths")

    def get_encoded(self, index: int) -> np.ndarray:
        """Return sequence ``index`` as an encoded ``uint8`` array."""
        raise NotImplementedError("BaseDatabase.get_encoded")

    def get_version(self) -> int:
        """A counter increased on every mutation (packing cache key)."""
        return 0

    # --- Properties ---------------------------------------------------------

    @property
    def lengths(self):
        """`list` of `int`: The length of each sequence in the database."""
        with self.lock.read:
            return [int(x) for x in self.get_lengths()]

    @property
    def total_length(self):
        """`int`: The total length of the database."""
        with self.lock.read:
            return int(sum(self.get_lengths()))

    # --- Sequence interface -------------------------------------------------

    def __contains__(self, query) -> bool:
        encoded = np.frombuffer(self.alphabet.encode(query), dtype=np.uint8)
        with self.lock.read:
            for i in range(self.get_size()):
                seq = self.get_encoded(i)
                if seq.shape[0] == encoded.shape[0] and np.array_equal(
                    seq, encoded
                ):
                    return True
        return False

    def __len__(self) -> int:
        with self.lock.read:
            return self.get_size()

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]

    def __getitem__(self, index):
        import operator

        index_ = operator.index(index)
        with self.lock.read:
            size = self.get_size()
            if index_ < 0:
                index_ += size
            if index_ < 0 or index_ >= size:
                raise IndexError(index)
            seq = self.get_encoded(index_)
        return self.alphabet.decode(seq)


class Database(BaseDatabase):
    """A database of target sequences.

    Sequences are stored ordinal-encoded (one immutable ``numpy.uint8``
    array each); `mask`/`extract`/slicing share the underlying arrays
    with zero copies (reference: ``shared_ptr`` aliasing at
    ``lib.pyx:694-778``).

    Example:
        >>> db = Database(["ATGC"])
        >>> db.extend(["TTCA", "AAAA", "GGTG"])
        >>> list(db)
        ['ATGC', 'TTCA', 'AAAA', 'GGTG']

    """

    def __init__(self, sequences=(), alphabet=None) -> None:
        super().__init__(alphabet=alphabet)
        self._sequences: list = []
        self._version = 0
        self._pack_cache: dict = {}
        self.extend(sequences)

    def __reduce__(self):
        return (type(self), ((), self.alphabet), None, iter(self))

    # --- Database interface -------------------------------------------------

    def get_size(self) -> int:
        return len(self._sequences)

    def get_lengths(self):
        return [seq.shape[0] for seq in self._sequences]

    def get_encoded(self, index: int) -> np.ndarray:
        return self._sequences[index]

    def get_version(self) -> int:
        return self._version

    def _bump(self) -> None:
        self._version += 1
        self._pack_cache.clear()

    # --- Encoding utility ----------------------------------------------------

    def _encode(self, sequence) -> np.ndarray:
        if isinstance(sequence, str):
            sequence = sequence.encode("ascii")
        seq = np.frombuffer(memoryview(sequence), dtype=np.uint8)
        encoded = self.alphabet._encode_array(seq)
        encoded.setflags(write=False)
        return encoded

    # --- Sequence interface ---------------------------------------------------

    def __getitem__(self, index):
        if isinstance(index, slice):
            # size read and extraction under ONE read-lock span, so a
            # concurrent deletion between them cannot invalidate the
            # computed range.  The extraction body runs inline (NOT
            # via extract()): the shared lock is writer-preferring and
            # non-reentrant, so a nested lock.read here would deadlock
            # against any queued writer.
            with self.lock.read:
                indices = range(*index.indices(len(self._sequences)))
                return self._extract_locked(indices)
        return super().__getitem__(index)

    def __setitem__(self, index, sequence) -> None:
        import operator

        index_ = operator.index(index)
        encoded = self._encode(sequence)
        with self.lock.write:
            size = len(self._sequences)
            if index_ < 0:
                index_ += size
            if index_ < 0 or index_ >= size:
                raise IndexError(index)
            self._sequences[index_] = encoded
            self._bump()

    def __delitem__(self, index) -> None:
        import operator

        index_ = operator.index(index)
        with self.lock.write:
            size = len(self._sequences)
            if index_ < 0:
                index_ += size
            if index_ < 0 or index_ >= size:
                raise IndexError(index)
            del self._sequences[index_]
            self._bump()

    def clear(self) -> None:
        """Drop every sequence, leaving an empty database."""
        with self.lock.write:
            self._sequences.clear()
            self._bump()

    def extend(self, sequences) -> None:
        """Add every sequence of an iterable to the database.

        Example:
            >>> db = Database(["ATGC"])
            >>> db.extend(["TTCA", "AAAA", "GGTG"])
            >>> list(db)
            ['ATGC', 'TTCA', 'AAAA', 'GGTG']

        """
        # encode outside the lock (the expensive part), then insert
        # the whole batch under ONE write-lock span with ONE version
        # bump: bulk loads don't pay per-sequence lock round trips,
        # and concurrent readers never observe a half-extended batch
        encoded = [self._encode(s) for s in sequences]
        if not encoded:
            return
        with self.lock.write:
            self._sequences.extend(encoded)
            self._bump()

    def append(self, sequence) -> None:
        """Add one sequence at the end of the database.

        Example:
            >>> db = Database(["ATGC", "TTCA"])
            >>> db.append("AAAA")
            >>> list(db)
            ['ATGC', 'TTCA', 'AAAA']

        """
        encoded = self._encode(sequence)
        with self.lock.write:
            self._sequences.append(encoded)
            self._bump()

    def reverse(self) -> None:
        """Reverse the order of the stored sequences, in place.

        Example:
            >>> db = Database(['ATGC', 'TTGC', 'CTGC'])
            >>> db.reverse()
            >>> list(db)
            ['CTGC', 'TTGC', 'ATGC']

        """
        with self.lock.write:
            self._sequences.reverse()
            self._bump()

    def insert(self, index, sequence) -> None:
        """Insert a sequence before position ``index``.

        Out-of-range indices clamp instead of raising, exactly like
        `list.insert`: a large negative ``index`` prepends, a large
        positive one appends::

            >>> db = Database(["ATGC", "TTGC", "CTGC"])
            >>> db.insert(-100, "TTTT")
            >>> db.insert(100, "AAAA")
            >>> list(db)
            ['TTTT', 'ATGC', 'TTGC', 'CTGC', 'AAAA']

        """
        import operator

        index_ = operator.index(index)
        encoded = self._encode(sequence)
        with self.lock.write:
            size = len(self._sequences)
            if index_ < 0:
                index_ += size
            if index_ < 0:
                index_ = 0
            elif index_ >= size:
                index_ = size
            self._sequences.insert(index_, encoded)
            self._bump()

    # --- Subset ---------------------------------------------------------------

    def mask(self, bitmask) -> "Database":
        """Build a sub-database of the positions where ``bitmask`` is `True`.

        The selected sequences are shared with this database, not
        copied — subsetting a multi-gigabyte database is O(selection),
        not O(bytes).

        Raises:
            `IndexError`: When ``bitmask`` is shorter or longer than
                the database.

        Example:
            >>> db = Database(['AAAA', 'CCCC', 'KKKK', 'FFFF'])
            >>> list(db.mask([True, False, False, True]))
            ['AAAA', 'FFFF']

        """
        subdb = Database.__new__(Database)
        BaseDatabase.__init__(subdb, alphabet=self.alphabet)
        subdb._sequences = []
        subdb._version = 0
        subdb._pack_cache = {}
        with self.lock.read:
            size = self.get_size()
            i = 0
            for b in bitmask:
                if i >= size:
                    raise IndexError(bitmask)
                if b:
                    subdb._sequences.append(self._sequences[i])
                i += 1
            if i < size:
                raise IndexError(bitmask)
        return subdb

    def extract(self, indices) -> "Database":
        """Build a sub-database from the sequences at ``indices``, in order.

        Like `mask`, the underlying encoded sequences are shared
        rather than copied.  Indices may repeat; the result follows
        the order of ``indices``, and negative indices are rejected
        (they would be ambiguous in a hit list keyed by global target
        index).

        Raises:
            `IndexError`: When ``indices`` holds a negative or
                out-of-range value.

        Example:
            >>> db = Database(['AAAA', 'CCCC', 'KKKK', 'FFFF'])
            >>> list(db.extract([2, 0]))
            ['KKKK', 'AAAA']

        """
        with self.lock.read:
            return self._extract_locked(indices)

    def _extract_locked(self, indices) -> "Database":
        """`extract` body; caller must hold the read lock."""
        subdb = Database.__new__(Database)
        BaseDatabase.__init__(subdb, alphabet=self.alphabet)
        subdb._sequences = []
        subdb._version = 0
        subdb._pack_cache = {}
        size = self.get_size()
        for index in indices:
            if index < 0 or index >= size:
                raise IndexError(index)
            subdb._sequences.append(self._sequences[index])
        return subdb
