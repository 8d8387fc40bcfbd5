"""Build CUDA sources into shared libraries (nvcc, ctypes).

Each source is compiled once per content hash (the source, the headers
it includes from ``csrc/`` and the flags) into ``build/repro_torch/``
at the root of the checkout, by ``nvcc`` into a shared library with a
plain C interface, and loaded with :mod:`ctypes`.  A library is named
after its kernel (``sg`` for a generated group kernel,
``flash_attention`` for ``csrc/flash_attention.cu``, ...) and the
hash.  The flags keep the float arithmetic IEEE: ``-fmad=false``
forbids contracting a multiply and an add into one FMA, and without
``--use_fast_math`` ``expf``, ``sqrtf`` and division round as the plain
PyTorch version's op-by-op evaluation does.  A missing ``nvcc`` or a
failed build raises :class:`KernelBuildError`; nothing falls back.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Sequence

__all__ = ["KernelBuildError", "NVCC_FLAGS", "BUILD_DIR", "CSRC_DIR",
           "find_nvcc", "included_headers", "library_path",
           "build_libraries", "load_library", "CudaSource"]

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
#: nvcc output, beside the checkout's src/ (listed in .gitignore)
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
#: where the CUDA toolkit's nvcc lives when it is not on PATH
CUDA_NVCC = Path("/usr/local/cuda/bin/nvcc")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-fmad=false", "-std=c++17", "-shared", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_loaded: dict[Path, ctypes.CDLL] = {}
_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused a generated source."""


def find_nvcc(names: Sequence[str] = ()) -> str:
    """The nvcc to build with; ``names`` are the kernels about to be
    built, for the error message."""
    nvcc = shutil.which("nvcc")
    if nvcc is None and CUDA_NVCC.exists():
        nvcc = str(CUDA_NVCC)
    if nvcc is None:
        what = ", ".join(sorted(set(names))) or "a kernel"
        raise KernelBuildError(
            f"nvcc not found on PATH or at {CUDA_NVCC}; cannot build "
            f"{what} (kernels are built from source at first use)")
    return nvcc


def included_headers(source: str) -> list[Path]:
    """The ``csrc/`` headers ``source`` includes, directly or through
    another header, in first-seen order."""
    seen: list[Path] = []
    todo = [source]
    while todo:
        for name in _INCLUDE.findall(todo.pop()):
            path = CSRC_DIR / name
            if path.exists() and path not in seen:
                seen.append(path)
                todo.append(path.read_text())
    return seen


def _digest(source: str) -> str:
    h = hashlib.sha256(source.encode())
    for header in included_headers(source):
        h.update(header.name.encode())
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:20]


def library_path(name: str, source: str) -> Path:
    """Where the library of kernel ``name`` built from ``source`` lives."""
    if not re.fullmatch(r"[A-Za-z_][A-Za-z0-9_]*", name):
        raise ValueError(f"kernel name {name!r} is not an identifier")
    return BUILD_DIR / f"{name}_{_digest(source)}.so"


def build_libraries(kernels: Sequence[tuple[str, str]]) -> list[Path]:
    """Build every ``(name, source)`` not built yet, one nvcc each, all
    at once.

    Returns the library paths in order.  Raises
    :class:`KernelBuildError` with nvcc's output if any build fails.
    """
    paths = [library_path(n, s) for n, s in kernels]
    todo = {p: s for p, (_, s) in zip(paths, kernels) if not p.exists()}
    if not todo:
        return paths
    nvcc = find_nvcc([n for p, (n, _) in zip(paths, kernels) if p in todo])
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


def load_library(name: str, source: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name`` for ``source``, built on
    first use."""
    path = library_path(name, source)
    with _lock:
        lib = _loaded.get(path)
        if lib is None:
            build_libraries([(name, source)])
            lib = ctypes.CDLL(str(path))
            _loaded[path] = lib
    return lib


class CudaSource:
    """A hand-written kernel source, ``csrc/<name>.cu``, and the C
    functions of its library.

    The library is built and loaded at the first :meth:`function` call,
    never at construction, so modules that hold one import without
    nvcc.  The source exports ``<name>_error_string`` for
    :meth:`check`.
    """

    def __init__(self, name: str):
        self.name = name
        self.path = CSRC_DIR / f"{name}.cu"
        self._functions: dict[str, ctypes._CFuncPtr] = {}
        self._lib: ctypes.CDLL | None = None

    @property
    def source(self) -> str:
        return self.path.read_text()

    def function(self, symbol: str, argtypes: Sequence) -> ctypes._CFuncPtr:
        """The library's C function ``symbol``, returning an int error
        code, with ``argtypes`` declared."""
        fn = self._functions.get(symbol)
        if fn is None:
            if self._lib is None:
                self._lib = load_library(self.name, self.source)
                err = getattr(self._lib, f"{self.name}_error_string")
                err.argtypes = [ctypes.c_int]
                err.restype = ctypes.c_char_p
            fn = getattr(self._lib, symbol)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
            self._functions[symbol] = fn
        return fn

    def check(self, rc: int) -> None:
        """Raise if a launch function returned a CUDA error."""
        if rc != 0:
            msg = getattr(self._lib, f"{self.name}_error_string")(rc)
            raise RuntimeError(
                f"{self.name} launch failed ({rc}): {msg.decode()}")
