"""ctypes bindings for the native ETL loops (fastetl.cpp) and the prefetch
loader (loader.cpp).

Counterpart of ``deep_recommenders_tpu/native``, with its own copies of the
two sources. At first use they compile into one library:

    g++ -O3 -shared -fPIC fastetl.cpp loader.cpp \
        -o build/native/libfastetl-<hash>.so -lpthread

``build/native`` lies at the root of the checkout (``build/`` is listed in
``.gitignore``); the name carries a hash of the sources and the flags, so an
edited source builds anew. The CRC-32 is computed from a table of the port's
own (``fastetl.cpp``), so the library needs no zlib.

Every function here is the native path and raises ``RuntimeError`` when the
library cannot be built: nothing falls back quietly. A caller that may take
a Python path instead asks :func:`available` first (the feature hashing of
``features/columns.py`` and ``load_ml1m`` do, with bit-identical results).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Dict, Iterator, Optional, Sequence, Tuple

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
SOURCES = (os.path.join(_DIR, "fastetl.cpp"), os.path.join(_DIR, "loader.cpp"))
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_DIR)), "build",
                         "native")
GXX_FLAGS = ("-O3", "-shared", "-fPIC")
LIBS = ("-lpthread",)

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_error: Optional[RuntimeError] = None  # a failed build, raised again

_i64p = ctypes.POINTER(ctypes.c_int64)
_i32p = ctypes.POINTER(ctypes.c_int32)
_f32p = ctypes.POINTER(ctypes.c_float)
_SIGNATURES = {
    "parse_ml1m_ratings": (ctypes.c_int64, [
        ctypes.c_char_p, _i64p, _i64p, _i64p, _i64p, ctypes.c_int64]),
    "crc32_bucket": (None, [
        ctypes.c_char_p, _i64p, ctypes.c_int64, ctypes.c_int64, _i32p]),
    "pack_bags": (None, [
        _i32p, _i64p, ctypes.c_int64, ctypes.c_int64, _i32p, _f32p]),
    "loader_create": (ctypes.c_void_p, [
        ctypes.c_int64, ctypes.POINTER(ctypes.c_void_p), _i64p,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_uint64,
        ctypes.c_int]),
    "loader_slot_ptrs": (None, [
        ctypes.c_void_p, ctypes.c_int64, ctypes.POINTER(ctypes.c_void_p)]),
    "loader_acquire": (ctypes.c_int64, [ctypes.c_void_p]),
    "loader_release": (None, [ctypes.c_void_p, ctypes.c_int64]),
    "loader_destroy": (None, [ctypes.c_void_p]),
}


def library_path() -> str:
    digest = hashlib.sha256(" ".join(GXX_FLAGS + LIBS).encode())
    for path in SOURCES:
        with open(path, "rb") as f:
            digest.update(f.read())
    return os.path.join(BUILD_DIR,
                        f"libfastetl-{digest.hexdigest()[:16]}.so")


def library() -> ctypes.CDLL:
    """The native library, compiled with g++ at first use; raises
    ``RuntimeError`` with the compiler's output when it cannot be built
    (and again, without another attempt, on every later call)."""
    global _lib, _error
    with _lock:
        if _lib is not None:
            return _lib
        if _error is not None:
            raise _error
        path = library_path()
        if not os.path.exists(path):
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{path}.{os.getpid()}.tmp"
            try:
                proc = subprocess.run(
                    ["g++", *GXX_FLAGS, *SOURCES, "-o", tmp, *LIBS],
                    capture_output=True, text=True, timeout=300,
                )
                log = proc.stderr
            except (OSError, subprocess.SubprocessError) as e:
                proc, log = None, str(e)
            if proc is None or proc.returncode != 0:
                if os.path.exists(tmp):
                    os.remove(tmp)
                _error = RuntimeError(f"native ETL build failed:\n{log}")
                raise _error
            os.replace(tmp, path)  # atomic: a concurrent build loads either
        lib = ctypes.CDLL(path)
        for name, (restype, argtypes) in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.restype, fn.argtypes = restype, argtypes
        _lib = lib
        return lib


def available() -> bool:
    """Whether the native library is built or can be built here."""
    try:
        library()
    except RuntimeError:
        return False
    return True


def _ptr(a: np.ndarray, kind):
    return a.ctypes.data_as(kind)


def parse_ml1m_ratings(
    path: str, max_rows: int = 1_100_000
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Parse ratings.dat -> (uid, mid, rating, ts) int64 arrays."""
    lib = library()
    cols = [np.empty(max_rows, np.int64) for _ in range(4)]
    n = lib.parse_ml1m_ratings(path.encode(),
                               *[_ptr(c, _i64p) for c in cols], max_rows)
    if n < 0:
        raise FileNotFoundError(path)
    return tuple(c[:n] for c in cols)


def crc32_bucket(values: Sequence, num_buckets: int) -> np.ndarray:
    """``zlib.crc32(str(v).encode()) % num_buckets`` of every value (bytes
    as they are), as int32."""
    lib = library()
    encoded = [v if isinstance(v, bytes) else str(v).encode("utf-8")
               for v in values]
    offsets = np.zeros(len(encoded) + 1, np.int64)
    np.cumsum([len(b) for b in encoded], out=offsets[1:])
    out = np.empty(len(encoded), np.int32)
    lib.crc32_bucket(b"".join(encoded), _ptr(offsets, _i64p), len(encoded),
                     num_buckets, _ptr(out, _i32p))
    return out


def pack_bags(flat_ids: np.ndarray, row_offsets: np.ndarray,
              max_len: int) -> Tuple[np.ndarray, np.ndarray]:
    """CSR bags (flat ids, ``n_rows + 1`` row offsets) -> padded (N, L) int32
    ids and float32 weights (1 on a real slot); a bag longer than
    ``max_len`` keeps its first ``max_len`` ids."""
    lib = library()
    flat_ids = np.ascontiguousarray(flat_ids, np.int32)
    row_offsets = np.ascontiguousarray(row_offsets, np.int64)
    n_rows = len(row_offsets) - 1
    if n_rows < 0 or np.any(np.diff(row_offsets) < 0) or (
            n_rows and (row_offsets[0] < 0
                        or row_offsets[-1] > len(flat_ids))):
        raise ValueError("row_offsets must ascend within flat_ids")
    ids = np.empty((n_rows, max_len), np.int32)
    wt = np.empty((n_rows, max_len), np.float32)
    lib.pack_bags(_ptr(flat_ids, _i32p), _ptr(row_offsets, _i64p), n_rows,
                  max_len, _ptr(ids, _i32p), _ptr(wt, _f32p))
    return ids, wt


class NativeStreamLoader:
    """Background-prefetch batch iterator over an encoded in-RAM corpus.

    A C++ producer thread (loader.cpp) gathers shuffled batch rows into a
    ring of ``capacity`` pre-allocated slots ahead of consumption, so host
    batch assembly overlaps device compute. Epochs cycle forever, each with
    its own shuffle (or the stored order with ``shuffle=False``); the
    remainder batch is dropped. The batches are the JAX package's loader's
    for the same seed.

    ``next_batch()`` copies the slot into fresh arrays and hands the slot
    back at once, so a batch the caller keeps is never overwritten by a
    later one (the producer refills a slot as soon as it is released; on
    the CPU, ``torch.as_tensor`` of a slot view would share its memory).
    There is no Python fallback: the constructor raises ``RuntimeError``
    when the native library cannot be built.
    """

    def __init__(self, features: Dict[str, np.ndarray], labels: np.ndarray,
                 batch_size: int, capacity: int = 4, seed: int = 42,
                 shuffle: bool = True):
        self._names = list(features)
        # Kept alive for the producer thread, which reads them by pointer.
        self._arrays = [np.ascontiguousarray(features[k])
                        for k in self._names]
        self._arrays.append(np.ascontiguousarray(labels))
        n_rows = self._arrays[0].shape[0]
        if any(a.shape[0] != n_rows for a in self._arrays):
            raise ValueError("all columns must share the leading dim")
        if batch_size <= 0 or capacity <= 0:
            raise ValueError("batch_size and capacity must be positive")
        if n_rows < batch_size:
            raise ValueError("corpus smaller than one batch")
        self.batch_size = batch_size
        self.num_examples = n_rows
        self.steps_per_epoch = n_rows // batch_size
        self._lib = library()
        n_cols = len(self._arrays)
        col_ptrs = (ctypes.c_void_p * n_cols)(
            *[a.ctypes.data for a in self._arrays])
        row_bytes = (ctypes.c_int64 * n_cols)(
            *[a.strides[0] for a in self._arrays])
        self._handle = self._lib.loader_create(
            n_cols, col_ptrs, row_bytes, n_rows, batch_size, capacity,
            seed, int(shuffle))
        if not self._handle:
            raise RuntimeError("loader_create refused its arguments")
        self._slot_views = []
        for s in range(capacity):
            ptrs = (ctypes.c_void_p * n_cols)()
            self._lib.loader_slot_ptrs(self._handle, s, ptrs)
            self._slot_views.append([
                np.frombuffer(
                    (ctypes.c_char * (batch_size * a.strides[0]))
                    .from_address(ptrs[c]), dtype=a.dtype,
                ).reshape((batch_size,) + a.shape[1:])
                for c, a in enumerate(self._arrays)
            ])

    def next_batch(self) -> Tuple[Dict[str, np.ndarray], np.ndarray]:
        """-> (features dict, labels): arrays of the next batch's rows,
        owned by the caller."""
        if not self._handle:
            raise RuntimeError("loader is closed")
        s = self._lib.loader_acquire(self._handle)
        if s < 0:
            raise RuntimeError("loader stopped")
        try:
            out = [v.copy() for v in self._slot_views[s]]
        finally:
            self._lib.loader_release(self._handle, s)
        return dict(zip(self._names, out[:-1])), out[-1]

    def __iter__(self) -> Iterator[Tuple[Dict[str, np.ndarray], np.ndarray]]:
        while True:
            yield self.next_batch()

    def epoch_batches(self):
        """One epoch's batches, for ``Trainer.fit(train_batches=...)``."""
        for _ in range(self.steps_per_epoch):
            yield self.next_batch()

    def close(self) -> None:
        """Stop the producer thread and free the ring."""
        if self._handle:
            self._lib.loader_destroy(self._handle)
            self._handle = None

    def __enter__(self) -> "NativeStreamLoader":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __del__(self):
        if getattr(self, "_handle", None):
            self.close()
