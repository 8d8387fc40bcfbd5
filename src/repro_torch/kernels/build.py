"""Build generated CUDA sources into shared libraries (nvcc, ctypes).

Each source is compiled once per content hash (the source, the header
it includes and the flags) into ``build/repro_torch/`` at the root of
the checkout, by ``nvcc`` into a shared library with a plain C
interface, and loaded with :mod:`ctypes`.  The flags keep the float
arithmetic IEEE: ``-fmad=false`` forbids contracting a multiply and an
add into one FMA, and without ``--use_fast_math`` ``expf``, ``sqrtf``
and division round as the plain PyTorch version's op-by-op evaluation
does.  A missing ``nvcc`` or a failed build raises
:class:`KernelBuildError`; nothing falls back.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

__all__ = ["KernelBuildError", "NVCC_FLAGS", "BUILD_DIR", "CSRC_DIR",
           "find_nvcc", "library_path", "build_libraries", "load_library"]

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
#: nvcc output, beside the checkout's src/ (listed in .gitignore)
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
#: where the CUDA toolkit's nvcc lives when it is not on PATH
CUDA_NVCC = Path("/usr/local/cuda/bin/nvcc")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-fmad=false", "-std=c++17", "-shared", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused a generated source."""


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None and CUDA_NVCC.exists():
        nvcc = str(CUDA_NVCC)
    if nvcc is None:
        raise KernelBuildError(
            f"nvcc not found on PATH or at {CUDA_NVCC}; the group kernel is "
            f"built from source at first use")
    return nvcc


def _digest(source: str) -> str:
    h = hashlib.sha256(source.encode())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:20]


def library_path(source: str) -> Path:
    """Where the library built from ``source`` lives."""
    return BUILD_DIR / f"sg_{_digest(source)}.so"


def build_libraries(sources: list[str]) -> list[Path]:
    """Build every source not built yet, one nvcc each, all at once.

    Returns the library paths in order.  Raises
    :class:`KernelBuildError` with nvcc's output if any build fails.
    """
    paths = [library_path(s) for s in sources]
    todo = {p: s for p, s in zip(paths, sources) if not p.exists()}
    if not todo:
        return paths
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for lib, src in todo.items():
        cu = lib.with_suffix(".cu")
        cu.write_text(src)
        tmp = lib.with_name(f"{lib.stem}.{os.getpid()}.tmp.so")
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC_DIR), "-o", str(tmp),
               str(cu)]
        procs.append((lib, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failures = []
    for lib, tmp, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"{lib.with_suffix('.cu')}:\n{out}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, lib)
    if failures:
        raise KernelBuildError("nvcc failed:\n" + "\n".join(failures))
    return paths


def load_library(source: str) -> ctypes.CDLL:
    """The loaded library for ``source``, built on first use."""
    key = _digest(source)
    with _lock:
        lib = _loaded.get(key)
        if lib is None:
            (path,) = build_libraries([source])
            lib = ctypes.CDLL(str(path))
            _loaded[key] = lib
    return lib
