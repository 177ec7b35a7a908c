"""Build the port's host C++ helpers with g++ and load them with ctypes.

``native/<name>.cpp`` compiles into ``_build/native_<name>.so`` (the
directory the CUDA kernels build into) at its first use in the process,
and again when the source is newer than the library.  A failed build
raises: no caller falls back to another path.  Nothing here runs at
import time.
"""

from __future__ import annotations

import ctypes
import functools
import os
import shutil
import subprocess
from pathlib import Path

NATIVE = Path(__file__).resolve().parent
BUILD = NATIVE.parent / "_build"
# no -march=native: the baseline x86-64 target has no fma, so g++ does not
# contract a*b + c and the helpers compute what their numpy versions do
FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")


def library_path(name: str) -> Path:
    return BUILD / f"native_{name}.so"


def build(name: str) -> Path:
    """Compile ``native/<name>.cpp``; returns the library's path.  Raises
    RuntimeError if no C++ compiler is found or the compile fails."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise RuntimeError(f"no C++ compiler (g++ or c++) on PATH to build "
                           f"native/{name}.cpp")
    src = NATIVE / f"{name}.cpp"
    BUILD.mkdir(parents=True, exist_ok=True)
    out = library_path(name)
    tmp = BUILD / f"native_{name}.{os.getpid()}.tmp.so"
    res = subprocess.run([cxx, *FLAGS, "-o", str(tmp), str(src)],
                         capture_output=True, text=True, timeout=300)
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{cxx} failed for native/{name}.cpp "
                           f"(exit {res.returncode}):\n{res.stderr}")
    # an atomic rename: a concurrent loader never maps a half-written file
    os.replace(tmp, out)
    return out


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``native/<name>.cpp``, built first where it is
    missing or older than its source."""
    so, src = library_path(name), NATIVE / f"{name}.cpp"
    if not so.is_file() or so.stat().st_mtime < src.stat().st_mtime:
        build(name)
    return ctypes.CDLL(str(so))
