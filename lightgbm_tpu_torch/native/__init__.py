"""Native host code: C++ sources built with ``g++`` and loaded via ctypes.

The port of ``lightgbm_tpu/native/__init__.py``'s ``load_native``,
``binning()`` and ``text_parser()``. Each source (``binning.cpp``: the
greedy bound search and the value-to-bin passes; ``text_parser.cpp``: the
CSV / TSV / LibSVM readers) is compiled with ``g++ -O3 -shared -fPIC
-std=c++17`` at first use into ``build/torch_native/`` at the root of the
checkout (git-ignored), keyed by a hash of the source and the flags. A
build writes a temporary name and renames it into place, so processes
that build at once never load a partial library.

There is no silent fallback: a failed build raises with the compiler's
message. The NumPy functions of ``io/binning.py`` are the plain versions
the tests hold the native routes against; nothing on the main path calls
them in place of a native entry point.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Dict

SRC_DIR = Path(__file__).resolve().parent
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_native"
CXX = "g++"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_LOCK = threading.Lock()
_LOADED: Dict[str, ctypes.CDLL] = {}


def library_path(name: str) -> Path:
    """Where ``<name>.cpp``'s library lives, keyed by source and flags."""
    src = (SRC_DIR / f"{name}.cpp").read_bytes()
    tag = hashlib.sha256(src + " ".join(CXX_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}_{tag[:16]}.so"


def build(name: str) -> Path:
    """Compile ``<name>.cpp`` unless its library exists; returns its path.
    Raises ``RuntimeError`` with the compiler's output when it fails."""
    out = library_path(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [CXX, *CXX_FLAGS, "-o", str(tmp), str(SRC_DIR / f"{name}.cpp")]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=300)
    except OSError as e:
        raise RuntimeError(f"{CXX} could not run to build "
                           f"native/{name}.cpp: {e}") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{CXX} failed to build native/{name}.cpp "
                           f"(exit {proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, out)          # atomic: readers never see a partial .so
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``<name>.cpp``, building it first if needed."""
    lib = _LOADED.get(name)
    if lib is None:
        with _LOCK:
            lib = _LOADED.get(name)
            if lib is None:
                lib = ctypes.CDLL(str(build(name)))
                _LOADED[name] = lib
    return lib


def binning() -> ctypes.CDLL:
    """The native binning entry points (``greedy_find_bounds``,
    ``bin_numeric_column``, ``bin_matrix``)."""
    lib = load("binning")
    if not getattr(lib, "_sigs_set", False):
        c = ctypes
        lib.greedy_find_bounds.restype = c.c_int64
        lib.greedy_find_bounds.argtypes = [
            c.POINTER(c.c_double), c.POINTER(c.c_int64), c.c_int64,
            c.c_int64, c.c_int64, c.c_int64, c.POINTER(c.c_double)]
        lib.bin_numeric_column.restype = None
        lib.bin_numeric_column.argtypes = [
            c.c_void_p, c.c_int, c.c_int64, c.c_int64,
            c.POINTER(c.c_double), c.c_int64, c.c_int, c.c_int64,
            c.c_int64, c.c_void_p, c.c_int, c.c_int64]
        lib.bin_matrix.restype = None
        lib.bin_matrix.argtypes = [
            c.c_void_p, c.c_int, c.c_int64, c.c_int64,
            c.POINTER(c.c_int64), c.c_int64, c.POINTER(c.c_double),
            c.POINTER(c.c_int64), c.POINTER(c.c_int),
            c.POINTER(c.c_int64), c.POINTER(c.c_int64),
            c.POINTER(c.c_int), c.c_void_p, c.c_int]
        lib._sigs_set = True
    return lib


def text_parser() -> ctypes.CDLL:
    """The native text readers (``count_lines``, ``count_fields``,
    ``parse_dense``, ``parse_libsvm``)."""
    lib = load("text_parser")
    if not getattr(lib, "_sigs_set", False):
        c = ctypes
        lib.count_lines.restype = c.c_long
        lib.count_lines.argtypes = [c.c_char_p]
        lib.count_fields.restype = c.c_int
        lib.count_fields.argtypes = [c.c_char_p, c.c_char]
        lib.parse_dense.restype = c.c_long
        lib.parse_dense.argtypes = [
            c.c_char_p, c.c_char, c.c_int,
            c.POINTER(c.c_double), c.c_long, c.c_int]
        lib.parse_libsvm.restype = c.c_long
        lib.parse_libsvm.argtypes = [
            c.c_char_p, c.c_int, c.POINTER(c.c_int), c.POINTER(c.c_int),
            c.POINTER(c.c_double), c.POINTER(c.c_double), c.c_long,
            c.c_long]
        lib._sigs_set = True
    return lib
