"""Build and load the port's CUDA kernels.

Each ``tagan_torch/csrc/<name>.cu`` has a plain C interface. It is
compiled with ``nvcc`` for ``sm_90a`` into ``tagan_torch/_build/`` (listed
in ``.gitignore``) at first use and loaded with ctypes. The library's
file name carries a hash of the source, the shared ``csrc/*.cuh``
headers and the flags, so an edited source or header is rebuilt.
Nothing is built when a module is imported: the CPU tests import every
module, and this machine may have no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable

PACKAGE = Path(__file__).resolve().parent.parent
CSRC = PACKAGE / "csrc"
BUILD_DIR = PACKAGE / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: Dict[str, ctypes.CDLL] = {}
# the compiler's output (ptxas register and spill report) of each library
# built by this process, and the seconds its nvcc ran
build_logs: Dict[str, str] = {}
build_seconds: Dict[str, float] = {}


def nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA "
                           "kernels are built on a machine with the CUDA "
                           "toolkit")
    return found


def library_path(name: str) -> Path:
    """The library of ``csrc/<name>.cu``, tagged with a hash of the
    source, every shared header in ``csrc/`` and the flags."""
    src = (CSRC / f"{name}.cu").read_bytes() + b"".join(
        h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{tag[:16]}.so"


def build(names: Iterable[str]) -> None:
    """Compile every named source that has no current library, all
    ``nvcc`` processes started together. Raises with the compiler's
    output if one fails."""
    todo = [n for n in dict.fromkeys(names) if not library_path(n).exists()]
    if not todo:
        return
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    exe = nvcc()
    procs = {}
    t0 = time.perf_counter()

    def collect(n, proc):
        build_logs[n] = proc.communicate()[0]
        build_seconds[n] = time.perf_counter() - t0
    for n in todo:
        tmp = library_path(n).with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.Popen(
            [exe, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        # one reader per process, so that each finish time is its own
        reader = threading.Thread(target=collect, args=(n, proc))
        reader.start()
        procs[n] = (tmp, proc, reader)
    failed = []
    for n, (tmp, proc, reader) in procs.items():
        reader.join()
        log = build_logs[n]
        if proc.returncode != 0:
            failed.append(f"{n}:\n{log}")
            continue
        os.replace(tmp, library_path(n))
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built if needed."""
    lib = _loaded.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        _loaded[name] = lib
    return lib
