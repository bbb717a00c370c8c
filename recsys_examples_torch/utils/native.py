"""ctypes bindings for the host-side C++ components in the repo's `csrc/`
(counterpart of recsys_examples_tpu/utils/native.py and of the KK loader
in recsys_examples_tpu/data/batch_shuffler.py).

`csrc/<name>.cpp` is compiled with g++ at first use into
`recsys_examples_torch/_build/` (listed in .gitignore) as
`lib<name>-<hash>.so`, the hash covering the source and the flags, so an
edited source is rebuilt; nothing is written under `csrc/`. A failed build
leaves the loader returning None, and its callers take their Python paths;
the compiler's output is kept in `BUILD_ERRORS`. Plain C ABI, no pybind11.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from typing import Dict, Optional

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
