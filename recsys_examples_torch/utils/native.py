"""ctypes bindings for the host-side C++ components in the repo's `csrc/`
(counterpart of recsys_examples_tpu/utils/native.py and of the KK loader
in recsys_examples_tpu/data/batch_shuffler.py).

`csrc/<name>.cpp` is compiled with g++ at first use into
`recsys_examples_torch/_build/` (listed in .gitignore) as
`lib<name>-<hash>.so`, the hash covering the source and the flags, so an
edited source is rebuilt; nothing is written under `csrc/`. A failed build
leaves the loader returning None and keeps the compiler's output in
`BUILD_ERRORS`: the batch packer and the partitioner then take their Python
paths, while `NativeHostStore` (the host tiers' store, `csrc/host_store.cpp`)
raises, having no other path. Plain C ABI, no pybind11.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from typing import Dict, Iterator, Optional, Tuple

import numpy as np

from recsys_examples_torch.utils.cuda_build import BUILD_DIR, PKG_DIR

CSRC_DIR = PKG_DIR.parent / "csrc"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared")

BUILD_ERRORS: Dict[str, str] = {}
_LIBS: Dict[str, Optional[ctypes.CDLL]] = {}


def _build_and_load(name: str) -> Optional[ctypes.CDLL]:
    """The loaded library of `csrc/<name>.cpp`, built first if missing; None
    if it cannot be built or loaded. Builds into a per-process temporary
    name and renames, so concurrent processes never load a half-written
    file."""
    if name in _LIBS:
        return _LIBS[name]
    src = CSRC_DIR / f"{name}.cpp"
    lib = None
    try:
        h = hashlib.sha256(src.read_bytes() + " ".join(CXX_FLAGS).encode()).hexdigest()[:16]
        out = BUILD_DIR / f"lib{name}-{h}.so"
        if not out.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            proc = subprocess.run([os.environ.get("CXX", "g++"), *CXX_FLAGS, "-o", str(tmp),
                                   str(src)], capture_output=True, text=True)
            if proc.returncode != 0:
                raise OSError(proc.stdout + proc.stderr)
            os.replace(tmp, out)
        lib = ctypes.CDLL(str(out))
    except OSError as e:     # no compiler, a failed build, or an unloadable file
        BUILD_ERRORS[name] = str(e)
    _LIBS[name] = lib
    return lib


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


def batch_assembler_lib() -> Optional[ctypes.CDLL]:
    """csrc/batch_assembler.cpp's library, or None."""
    fresh = "batch_assembler" not in _LIBS
    lib = _build_and_load("batch_assembler")
    if lib is not None and fresh:
        lib.assemble_batch.restype = ctypes.c_int64
        lib.assemble_batch.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int64, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ]
    return lib


def kk_partition_lib() -> Optional[ctypes.CDLL]:
    """csrc/kk_partition.cpp's library (`kk_partition`, `lpt_partition`),
    or None."""
    fresh = "kk_partition" not in _LIBS
    lib = _build_and_load("kk_partition")
    if lib is not None and fresh:
        argtypes = [
            ctypes.POINTER(ctypes.c_double), ctypes.c_int64, ctypes.c_int32,
            ctypes.c_int64, ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_double),
        ]
        lib.kk_partition.argtypes = argtypes
        lib.lpt_partition.argtypes = argtypes
        lib.kk_partition.restype = lib.lpt_partition.restype = None
    return lib


def host_store_lib() -> ctypes.CDLL:
    """csrc/host_store.cpp's library; raises when it cannot be built."""
    fresh = "host_store" not in _LIBS
    lib = _build_and_load("host_store")
    if lib is None:
        raise RuntimeError("csrc/host_store.cpp did not build or load: "
                           + BUILD_ERRORS.get("host_store", "?"))
    if fresh:
        vp, i64 = ctypes.c_void_p, ctypes.c_int64
        lib.host_store_create.restype = vp
        lib.host_store_create.argtypes = [i64]
        lib.host_store_destroy.argtypes = [vp]
        lib.host_store_size.restype = i64
        lib.host_store_size.argtypes = [vp]
        lib.host_store_put.argtypes = [vp, vp, vp, vp, i64]
        lib.host_store_get.argtypes = [vp, vp, vp, vp, vp, i64]
        lib.host_store_erase.argtypes = [vp, vp, i64]
        lib.host_store_export.restype = i64
        lib.host_store_export.argtypes = [vp, i64, vp, i64, vp, vp, vp]
    return lib


class NativeHostStore:
    """int64 key -> (float32 row [row_dim], int64 score), in host RAM, over
    csrc/host_store.cpp (counterpart of recsys_examples_tpu/utils/native.py
    `NativeHostStore`, without its dict fallback: the store raises when the
    library cannot be built)."""

    def __init__(self, row_dim: int):
        self.row_dim = row_dim
        self._lib = host_store_lib()
        self._h = ctypes.c_void_p(self._lib.host_store_create(row_dim * 4))

    def __len__(self) -> int:
        return int(self._lib.host_store_size(self._h))

    def put(self, keys: np.ndarray, rows: np.ndarray,
            scores: Optional[np.ndarray] = None) -> None:
        """Insert or overwrite rows (score 0 when `scores` is None)."""
        keys = np.ascontiguousarray(keys, np.int64)
        rows = np.ascontiguousarray(rows, np.float32)
        n = len(keys)
        if n == 0:
            return
        scores = np.zeros((n,), np.int64) if scores is None else np.ascontiguousarray(
            scores, np.int64)
        self._lib.host_store_put(self._h, _ptr(keys), _ptr(rows), _ptr(scores), n)

    def get_scored(self, keys: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(rows [n, row_dim] f32, scores [n] int64, found [n] bool); rows
        and scores of missing keys are 0."""
        keys = np.ascontiguousarray(keys, np.int64)
        n = len(keys)
        rows = np.zeros((n, self.row_dim), np.float32)
        scores = np.zeros((n,), np.int64)
        found = np.zeros((n,), np.uint8)
        if n:
            self._lib.host_store_get(self._h, _ptr(keys), _ptr(rows), _ptr(scores),
                                     _ptr(found), n)
        return rows, scores, found.astype(bool)

    def get(self, keys: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """(rows [n, row_dim] f32, found [n] bool)."""
        rows, _, found = self.get_scored(keys)
        return rows, found

    def erase(self, keys: np.ndarray) -> None:
        keys = np.ascontiguousarray(keys, np.int64)
        if len(keys):
            self._lib.host_store_erase(self._h, _ptr(keys), len(keys))

    def export(self, score_threshold: int = 0, batch: int = 65536
               ) -> Iterator[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
        """Yield (keys, rows, scores) batches with score >= threshold, in the
        store's slot order."""
        cursor = ctypes.c_int64(0)
        while True:
            keys = np.zeros((batch,), np.int64)
            rows = np.zeros((batch, self.row_dim), np.float32)
            scores = np.zeros((batch,), np.int64)
            n = int(self._lib.host_store_export(
                self._h, score_threshold, ctypes.byref(cursor), batch,
                _ptr(keys), _ptr(rows), _ptr(scores)))
            if n == 0:
                break
            yield keys[:n], rows[:n], scores[:n]

    def __del__(self):
        h = getattr(self, "_h", None)
        if h is not None:
            self._lib.host_store_destroy(h)
            self._h = None
