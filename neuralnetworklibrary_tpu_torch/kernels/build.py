"""Build, load and bind every native library of the port with ctypes.

Each CUDA source ``csrc/<name>.cu`` compiles with nvcc, and each host C++
source ``native/<name>.cpp`` with g++, on its own into ``_build/lib<name>.so``,
a shared library with a plain C interface (no PyTorch headers, so a build
takes seconds).  Wrappers pass tensor pointers and the current stream as
integers; their ``argtypes`` use ``ctypes.c_void_p`` for each pointer.

A library is built at its first use in the process and rebuilt when its
source, or any header beside it (``*.cuh``, which the CUDA sources include),
is newer.  A failed build raises: no caller falls back to another path.
Nothing here runs at import time: the CPU tests import every module on a
machine without nvcc.
"""

from __future__ import annotations

import ctypes
import functools
import os
import shutil
import subprocess
import time
from pathlib import Path

PACKAGE = Path(__file__).resolve().parent.parent
CSRC = PACKAGE / "csrc"
NATIVE = PACKAGE / "native"
BUILD = PACKAGE / "_build"
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")
# no -march=native: the baseline x86-64 target has no fma, so g++ does not
# contract a*b + c and the host helpers compute what their numpy versions do
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
# the loaded libraries with their entry points declared, by source name
BOUND = {}


def sources() -> list:
    """Names of every kernel source under ``csrc/``."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def nvcc() -> str:
    """Path of nvcc: on PATH, else under CUDA_HOME (default /usr/local/cuda)."""
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    raise RuntimeError("nvcc not found on PATH or under CUDA_HOME; the "
                       "CUDA kernels build only where the CUDA toolkit is")


def cxx() -> str:
    """Path of the host C++ compiler: g++, else c++, on PATH."""
    found = shutil.which("g++") or shutil.which("c++")
    if found is None:
        raise RuntimeError("no C++ compiler (g++ or c++) on PATH to build "
                           "the host helpers in native/")
    return found


# (compiler, its flags) by the source's suffix
COMPILERS = {".cu": (nvcc, FLAGS), ".cpp": (cxx, CXX_FLAGS)}


def source(name: str) -> Path:
    """The source of library ``name``: ``csrc/<name>.cu`` or
    ``native/<name>.cpp``."""
    for path in (CSRC / f"{name}.cu", NATIVE / f"{name}.cpp"):
        if path.is_file():
            return path
    raise FileNotFoundError(f"no csrc/{name}.cu or native/{name}.cpp")


def library_path(name: str) -> Path:
    return BUILD / f"lib{name}.so"


def build(names=None) -> dict:
    """Compile the named sources (default: all of ``csrc/``) in parallel,
    one compiler process each.

    Returns ``{name: {"seconds": wall time, "log": the compiler's output}}``;
    nvcc's log carries ptxas's register and shared-memory report.  Raises
    RuntimeError if any compile fails.
    """
    names = sources() if names is None else list(names)
    BUILD.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        src = source(name)
        compiler, flags = COMPILERS[src.suffix]
        tmp = BUILD / f"lib{name}.{os.getpid()}.tmp.so"
        procs[name] = (time.perf_counter(), tmp, subprocess.Popen(
            [compiler(), *flags, "-o", str(tmp), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    results, failed = {}, []
    for name, (t0, tmp, proc) in procs.items():
        log, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"{name} (exit {proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
            continue
        # the rename is atomic, so a concurrent loader never maps a
        # half-written library
        os.replace(tmp, library_path(name))
        results[name] = {"seconds": seconds, "log": log}
    if failed:
        raise RuntimeError("build failed for " + "\n".join(failed))
    return results


def stale(so: Path, src: Path) -> bool:
    """Whether the library ``so`` is missing or older than its source
    ``src`` or any ``*.cuh`` header beside it."""
    if not so.is_file():
        return True
    newest = max(p.stat().st_mtime
                 for p in [src, *src.parent.glob("*.cuh")])
    return so.stat().st_mtime < newest


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The loaded library of source ``name``, built first if it is
    :func:`stale`."""
    so = library_path(name)
    if stale(so, source(name)):
        build([name])
    return ctypes.CDLL(str(so))


def declare(lib, signatures: dict):
    """Set ``argtypes`` and ``restype`` of each entry point of ``lib`` from
    ``signatures``, ``{name: (argtypes, restype)}``; returns ``lib``."""
    for name, (argtypes, restype) in signatures.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = argtypes, restype
    return lib


def bind(name: str, signatures: dict):
    """The library of source ``name`` with its entry points declared from
    ``signatures``, loaded at the first call and cached in :data:`BOUND`
    (a test or a tile sweep may put another library in its place)."""
    lib = BOUND.get(name)
    if lib is None:
        lib = BOUND[name] = declare(load(name), signatures)
    return lib


def check_call(name: str, signatures: dict, entry: str, *args) -> None:
    """Call ``entry`` of the library :func:`bind` gives and raise
    RuntimeError with the library's own text for a nonzero return code: the
    text comes from the one entry point of ``signatures`` that returns
    ``const char*``."""
    lib = bind(name, signatures)
    err = getattr(lib, entry)(*args)
    if err != 0:
        error_string = next(n for n, (_, restype) in signatures.items()
                            if restype is ctypes.c_char_p)
        text = getattr(lib, error_string)(err).decode()
        raise RuntimeError(f"{name} kernel launch failed: {text}")
