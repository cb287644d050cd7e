"""Token-batch feeder: the training input pipeline, in numpy.

The port's copy of the JAX package's ``data/feeder.py`` corpus format
and of its pure-Python ``PyTokenFeeder``, byte for byte in output order.
The native prefetching C++ feeder is not ported (ROADMAP Queue A), so
:func:`open_feeder` always returns :class:`PyTokenFeeder`.

Corpus format (``write_corpus``): magic ``KVFEED01``, uint64
little-endian token count, int32 tokens. Batch ``b`` row ``r`` covers
tokens ``[(b * global_batch + shard_offset + r) * seq, ... + seq + 1)``
wrapping modulo the corpus, so a run resumed at step ``k``
(``start_batch=k``) sees exactly the batches it would have seen without
the restart.
"""

from __future__ import annotations

import os
import struct

import numpy as np

MAGIC = b"KVFEED01"
_HEADER = struct.Struct("<8sQ")


def write_corpus(path: str | os.PathLike, tokens) -> None:
    """Write an int32 token corpus in the feeder's format."""
    arr = np.asarray(tokens, dtype=np.int32)
    if arr.ndim != 1:
        raise ValueError("corpus tokens must be a 1-D sequence")
    with open(path, "wb") as fh:
        fh.write(_HEADER.pack(MAGIC, arr.size))
        fh.write(arr.tobytes())


def read_corpus_header(path: str | os.PathLike) -> int:
    """Validate the header; return the token count."""
    with open(path, "rb") as fh:
        raw = fh.read(_HEADER.size)
    if len(raw) < _HEADER.size:
        raise ValueError("corpus file too small for header")
    magic, n_tokens = _HEADER.unpack(raw)
    if magic != MAGIC:
        raise ValueError(f"bad corpus magic {magic!r} (expected {MAGIC!r})")
    return n_tokens


class PyTokenFeeder:
    """``[batch, seq + 1]`` int32 batches in the reference's order.

    ``global_batch``/``shard_offset`` select this feeder's rows of a
    larger logical batch (0 = ``batch``, the single-host case);
    ``start_batch`` is a global batch index."""

    def __init__(self, path: str | os.PathLike, batch: int, seq: int,
                 start_batch: int = 0, global_batch: int = 0,
                 shard_offset: int = 0):
        global_batch = global_batch or batch
        if not (0 <= shard_offset and shard_offset + batch <= global_batch):
            raise ValueError(
                "shard must satisfy 0 <= shard_offset and "
                "shard_offset + batch <= global_batch"
            )
        self.n_tokens = read_corpus_header(path)
        if self.n_tokens < seq + 1:
            raise ValueError("corpus smaller than one sequence")
        self._tokens = np.fromfile(
            path, dtype=np.int32, offset=_HEADER.size
        )[: self.n_tokens]
        if self._tokens.size < self.n_tokens:
            raise ValueError(
                "corpus header claims more tokens than the file holds"
            )
        self._batch, self._seq = batch, seq
        self._global_batch, self._shard_offset = global_batch, shard_offset
        self._index = start_batch

    def __iter__(self):
        return self

    def __next__(self) -> np.ndarray:
        rows = (self._index * self._global_batch + self._shard_offset
                + np.arange(self._batch, dtype=np.int64))
        starts = rows * self._seq % self.n_tokens
        idx = (starts[:, None] + np.arange(self._seq + 1)) % self.n_tokens
        self._index += 1
        return self._tokens[idx]


def open_feeder(path: str | os.PathLike, batch: int, seq: int,
                start_batch: int = 0, global_batch: int = 0,
                shard_offset: int = 0):
    """The numpy feeder (the native one is not ported)."""
    return PyTokenFeeder(path, batch, seq, start_batch=start_batch,
                         global_batch=global_batch, shard_offset=shard_offset)
