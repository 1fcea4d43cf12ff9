"""Build the port's CUDA sources into shared libraries and load them.

Each ``csrc/*.cu`` file is compiled by ``nvcc`` on its own, for ``sm_90a``,
into a shared library with a plain C interface under ``build/repro_torch/``
at the root of the checkout, and loaded with ``ctypes``.  The library's name
carries a hash of its source, the ``csrc/*.cuh`` headers the sources share
and the compiler flags, so a build runs at first use and again only when
one of them changes.  All sources are compiled in parallel, one ``nvcc``
each.  A failed build raises with nvcc's output; a build's ``-Xptxas -v``
report (registers, spills) is kept beside its library.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, List

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# Loaded libraries by source stem: a process loads each library once.
_LIBS: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    for cand in (os.path.join(home, "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin, "
                       "/usr/local/cuda/bin and PATH): the CUDA kernels "
                       "cannot be built")


def _lib_path(src: Path) -> Path:
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{src.stem}-{h.hexdigest()[:16]}.so"


def build_all() -> Dict[str, object]:
    """Compile every source whose library is missing, all at once.

    Returns ``{"seconds": wall time, "built": [stems], "ptxas": {stem:
    nvcc's -Xptxas -v report}}``."""
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo = [(src, _lib_path(src)) for src in sorted(CSRC.glob("*.cu"))]
    todo = [(src, lib) for src, lib in todo if not lib.exists()]
    nvcc = _nvcc() if todo else ""
    procs = []
    for src, lib in todo:
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)]
        procs.append((src, lib, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    reports: Dict[str, str] = {}
    failed: List[str] = []
    for src, lib, tmp, proc in procs:
        out, _ = proc.communicate()
        reports[src.stem] = out
        if proc.returncode:
            failed.append(f"nvcc failed on {src.name} "
                          f"(exit {proc.returncode}):\n{out}")
        else:
            os.replace(tmp, lib)
            lib.with_suffix(".ptxas.txt").write_text(out)
    if failed:
        raise RuntimeError("\n".join(failed))
    return {"seconds": time.perf_counter() - t0,
            "built": [src.stem for src, _ in todo], "ptxas": reports}


def ptxas_report(stem: str) -> str:
    """nvcc's ``-Xptxas -v`` report of the build of ``csrc/<stem>.cu``'s
    current library, kept beside it ("" if it has not been built)."""
    path = _lib_path(CSRC / f"{stem}.cu").with_suffix(".ptxas.txt")
    return path.read_text() if path.exists() else ""


def load(stem: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<stem>.cu``, building it first
    if its library is missing."""
    if stem not in _LIBS:
        lib = _lib_path(CSRC / f"{stem}.cu")
        if not lib.exists():
            build_all()
        _LIBS[stem] = ctypes.CDLL(str(lib))
    return _LIBS[stem]
