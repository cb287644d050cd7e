"""Token-batch feeder: the training input pipeline.

The port's copy of the JAX package's ``data/feeder.py``: its corpus
format, its native prefetching feeder (:class:`TokenFeeder`, loaded
through ``ctypes`` with the same symbols) and its pure-Python
``PyTokenFeeder``, byte for byte in output order. The native library
is the repository's own ``native/kvedge-feed.cc`` (mmap, a worker thread
and a bounded ring buffer, so host IO and slicing overlap the device
step), built at first use with ``make`` and ``g++`` into the port's
git-ignored build directory (``build/kvedge_torch/``), named by a hash
of its source; nothing under ``native/`` is written. :func:`open_feeder`
returns the native feeder when the library loads, and otherwise warns
and falls back to :class:`PyTokenFeeder`, as the reference does.

Corpus format (``write_corpus``): magic ``KVFEED01``, uint64
little-endian token count, int32 tokens. Batch ``b`` row ``r`` covers
tokens ``[(b * global_batch + shard_offset + r) * seq, ... + seq + 1)``
wrapping modulo the corpus, so a run resumed at step ``k``
(``start_batch=k``) sees exactly the batches it would have seen without
the restart.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import struct
import subprocess
import tempfile
import threading
import warnings

import numpy as np

MAGIC = b"KVFEED01"
_HEADER = struct.Struct("<8sQ")

_REPO = pathlib.Path(__file__).resolve().parents[2]
NATIVE_DIR = _REPO / "native"
BUILD_DIR = _REPO / "build" / "kvedge_torch"
_SOURCES = ("kvedge-feed.cc", "kvedge-feed.h")

_lib = None
_lib_lock = threading.Lock()


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


def _library_path() -> pathlib.Path:
    """Where the native feeder of this source lives: named by a hash of
    ``native/kvedge-feed.{cc,h}``, so an edited source never loads a
    stale library."""
    digest = hashlib.sha256()
    for name in _SOURCES:
        digest.update((NATIVE_DIR / name).read_bytes())
    return BUILD_DIR / f"libkvedge-feed-{digest.hexdigest()[:16]}.so"


def _build_native() -> pathlib.Path:
    """Build the library once (``make -C native`` with ``BUILD_DIR`` a
    fresh directory under ``build/kvedge_torch/``, then moved into
    place, so concurrent builders never load a half-written file)."""
    lib_path = _library_path()
    if lib_path.exists():
        return lib_path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        target = pathlib.Path(tmp) / "libkvedge-feed.so"
        subprocess.run(
            ["make", "-C", str(NATIVE_DIR), f"BUILD_DIR={tmp}", str(target)],
            check=True, capture_output=True,
        )
        os.replace(target, lib_path)
    return lib_path


def _load_native():
    """Build (if needed) and load the native library; None if unavailable."""
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib or None
        try:
            # One-time lazy init: the module lock serializes the build
            # and the dlopen; waiters need the finished library anyway.
            lib = ctypes.CDLL(str(_build_native()))
            # Binding stays inside the try: a library lacking a symbol
            # must surface as the loud fallback, not a crash in
            # open_feeder.
            lib.kvf_open_sharded.restype = ctypes.c_void_p
            lib.kvf_open_sharded.argtypes = [
                ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_ulonglong, ctypes.c_int, ctypes.c_int,
            ]
            lib.kvf_next.restype = ctypes.c_int
            lib.kvf_next.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
            lib.kvf_tokens.restype = ctypes.c_ulonglong
            lib.kvf_tokens.argtypes = [ctypes.c_void_p]
            lib.kvf_close.argtypes = [ctypes.c_void_p]
            lib.kvf_last_error.restype = ctypes.c_char_p
        except (OSError, subprocess.SubprocessError, AttributeError) as e:
            # Loud fallback: a silently-degraded input pipeline is the
            # stall the native feeder exists to prevent, so say why (a
            # missing toolchain reads very differently from a broken
            # build).
            detail = ""
            if isinstance(e, subprocess.CalledProcessError) and e.stderr:
                detail = ": " + e.stderr.decode(errors="replace").strip()
            warnings.warn(
                "native feeder unavailable, using the pure-Python "
                f"fallback ({type(e).__name__}{detail})",
                RuntimeWarning, stacklevel=3,
            )
            _lib = False  # cached negative: no toolchain / a broken build
            return None
        _lib = lib
        return lib


class TokenFeeder:
    """Iterator of ``[batch, seq + 1]`` int32 batches via the native
    feeder: a worker thread fills a ring of ``depth`` batches ahead of
    the caller. The arguments are :class:`PyTokenFeeder`'s."""

    def __init__(self, path: str | os.PathLike, batch: int, seq: int, *,
                 start_batch: int = 0, global_batch: int = 0,
                 shard_offset: int = 0, depth: int = 4):
        lib = _load_native()
        if lib is None:
            raise RuntimeError(
                "native feeder library unavailable (no C++ toolchain?); "
                "use PyTokenFeeder or open_feeder() for the fallback"
            )
        self._lib = lib
        self._batch, self._seq = batch, seq
        self._handle = lib.kvf_open_sharded(
            str(path).encode(), batch, seq, depth, start_batch,
            global_batch or batch, shard_offset,
        )
        if not self._handle:
            raise ValueError(lib.kvf_last_error().decode())
        self.n_tokens = int(lib.kvf_tokens(self._handle))

    def __iter__(self):
        return self

    def __next__(self) -> np.ndarray:
        if self._handle is None:
            raise StopIteration
        out = np.empty((self._batch, self._seq + 1), np.int32)
        rc = self._lib.kvf_next(
            self._handle, out.ctypes.data_as(ctypes.c_void_p)
        )
        if rc != 0:
            raise StopIteration
        return out

    def close(self) -> None:
        if self._handle is not None:
            self._lib.kvf_close(self._handle)
            self._handle = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class PyTokenFeeder:
    """``[batch, seq + 1]`` int32 batches in the reference's order.

    ``global_batch``/``shard_offset`` select this feeder's rows of a
    larger logical batch (0 = ``batch``, the single-host case);
    ``start_batch`` is a global batch index."""

    def __init__(self, path: str | os.PathLike, batch: int, seq: int, *,
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

    def close(self) -> None:
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def open_feeder(path: str | os.PathLike, batch: int, seq: int, *,
                start_batch: int = 0, global_batch: int = 0,
                shard_offset: int = 0, depth: int = 4):
    """The native feeder when buildable, the numpy fallback otherwise
    (with the loader's warning). The options are keyword-only: the
    reference takes ``depth`` fourth, so a positional call copied from
    it fails here instead of resuming at another batch."""
    if _load_native() is not None:
        return TokenFeeder(path, batch, seq, start_batch=start_batch,
                           global_batch=global_batch,
                           shard_offset=shard_offset, depth=depth)
    return PyTokenFeeder(path, batch, seq, start_batch=start_batch,
                         global_batch=global_batch, shard_offset=shard_offset)
