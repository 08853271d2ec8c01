"""ctypes binding for the port's reverse Cuthill-McKee order (``rcm.cpp``).

``rcm.cpp`` beside this file orders node IDs by reverse Cuthill-McKee
(`core.graph.locality_order`, run by ``build_sequence(reorder="rcm")``
alone: packing itself is numpy and needs no compiler). It is compiled
with ``g++ -O3 -fPIC -std=c++17 -shared`` at first use into
``tagan_torch/_build/`` (listed in ``.gitignore``), the library's file
name tagged with a hash of the source and the flags, and loaded with
ctypes. The compiler writes to a name of its own process and the result
is renamed into place, so several processes may build at once.

A build or load that fails raises `RuntimeError` with the compiler's
output: the caller never falls back to the Python BFS in silence.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

from ..ops.build import BUILD_DIR

SOURCE = Path(__file__).resolve().with_name("rcm.cpp")
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-shared")

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()


def library_path() -> Path:
    """The library, tagged with a hash of the source and the flags."""
    tag = hashlib.sha256(SOURCE.read_bytes()
                         + " ".join(CXX_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"libtagan_rcm-{tag[:16]}.so"


def _build(path: Path) -> None:
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError(f"g++ not found: {SOURCE} is built with g++ at "
                           "first use of reorder='rcm'")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed for {SOURCE}:\n{proc.stdout}")
    os.replace(tmp, path)


def _load() -> ctypes.CDLL:
    """The loaded library, built if needed (raises RuntimeError)."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        path = library_path()
        if not path.exists():
            _build(path)
        try:
            lib = ctypes.CDLL(str(path))
        except OSError as e:
            raise RuntimeError(f"cannot load {path}: {e}") from e
        i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
        lib.tagan_rcm_order.restype = ctypes.c_int32
        lib.tagan_rcm_order.argtypes = [i64p, i64p, ctypes.c_int64,
                                        ctypes.c_int64, i64p]
        _lib = lib
        return lib


def rcm_order_native(src: np.ndarray, dst: np.ndarray, n: int) -> np.ndarray:
    """Reverse Cuthill-McKee order of an undirected [0, n) index graph
    in C++ (`core.graph.locality_order`): a permutation of 0..n-1,
    int64."""
    lib = _load()
    src = np.ascontiguousarray(src, np.int64)
    dst = np.ascontiguousarray(dst, np.int64)
    out = np.zeros(n, np.int64)
    rc = lib.tagan_rcm_order(src, dst, len(src), n, out)
    if rc != 0:
        raise ValueError(f"native RCM failed with code {rc}")
    return out
