"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` compiles on its own into ``_build/lib<name>.so``, a
shared library with a plain C interface (no PyTorch headers, so a build
takes seconds).  Wrappers pass tensor pointers and the current stream as
integers; their ``argtypes`` use ``ctypes.c_void_p`` for each pointer.

A library is built at its first use in the process and rebuilt when its
source, or any header under ``csrc/`` (``*.cuh``, which sources include),
is newer.  Nothing here runs at import time: the CPU tests import every
module on a machine without nvcc.
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
BUILD = PACKAGE / "_build"
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")


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


def library_path(name: str) -> Path:
    return BUILD / f"lib{name}.so"


def build(names=None) -> dict:
    """Compile the named sources (default: all) in parallel, one nvcc each.

    Returns ``{name: {"seconds": wall time, "log": nvcc's output}}``; the
    log carries ptxas's register and shared-memory report.  Raises
    RuntimeError if any compile fails.
    """
    names = sources() if names is None else list(names)
    exe = nvcc()
    BUILD.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        src = CSRC / f"{name}.cu"
        if not src.is_file():
            raise FileNotFoundError(src)
        tmp = BUILD / f"lib{name}.{os.getpid()}.tmp.so"
        procs[name] = (time.perf_counter(), tmp, subprocess.Popen(
            [exe, *FLAGS, "-o", str(tmp), str(src)],
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
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
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
    """The loaded library of ``csrc/<name>.cu``, built first if it is
    :func:`stale`."""
    so, src = library_path(name), CSRC / f"{name}.cu"
    if stale(so, src):
        build([name])
    return ctypes.CDLL(str(so))
