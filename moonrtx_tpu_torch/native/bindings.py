"""ctypes bindings for the native data-pipeline kernels (host code).

The shared library is built with g++ on first use into ``build/native/``
under the repository root, keyed by a hash of the source, the flags and
the host CPU (``-march=native``), so it never mixes with the JAX
package's library, a source change rebuilds, and a checkout copied to
another machine does not load a library built for other instructions.
Every entry point has a numpy fallback in the callers, so a missing
toolchain only costs speed, never functionality.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np

SRC = Path(__file__).resolve().parent / "src" / "downscale.cpp"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "native"
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall",
             "-shared", "-pthread")
_lib: Optional[ctypes.CDLL] = None


def _cpu_id() -> bytes:
    """The host CPU's model name and feature flags (Linux), or nothing."""
    try:
        with open("/proc/cpuinfo", "rb") as f:
            lines = f.read().splitlines()
    except OSError:
        return b""
    keys = (b"model name", b"flags")
    return b"".join(next((ln for ln in lines if ln.startswith(k)), b"")
                    for k in keys)


def _lib_path() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SRC.read_bytes())
    h.update(_cpu_id())
    return BUILD_ROOT / h.hexdigest()[:16] / "libmoonrtx_native.so"


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    path = _lib_path()
    if not path.is_file():
        path.parent.mkdir(parents=True, exist_ok=True)
        # build under a private name, then rename: concurrent first uses
        # never load a half-written library
        tmp = path.with_name(f"{path.name}.{os.getpid()}")
        subprocess.run([os.environ.get("CXX", "g++"), *CXX_FLAGS, str(SRC),
                        "-o", str(tmp)], check=True, capture_output=True)
        os.replace(tmp, path)
    lib = ctypes.CDLL(str(path))
    i64 = ctypes.c_int64
    lib.block_mean_int16.argtypes = [
        ctypes.POINTER(ctypes.c_int16), i64, i64, i64,
        ctypes.POINTER(ctypes.c_float), i64]
    lib.block_mean_f32.argtypes = [
        ctypes.POINTER(ctypes.c_float), i64, i64, i64,
        ctypes.POINTER(ctypes.c_float), i64]
    lib.resample_bilinear_f32.argtypes = [
        ctypes.POINTER(ctypes.c_float), i64, i64,
        ctypes.POINTER(ctypes.c_float), i64, i64, i64]
    _lib = lib
    return lib


def available() -> bool:
    try:
        _load()
        return True
    except Exception:
        return False


def block_mean_int16(src: np.ndarray, factor: int,
                     n_threads: int = 0) -> np.ndarray:
    """Multithreaded block-mean of an int16 raster -> float32."""
    lib = _load()
    src = np.ascontiguousarray(src, dtype=np.int16)
    h, w = src.shape
    dst = np.empty((h // factor, w // factor), np.float32)
    lib.block_mean_int16(
        src.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)), h, w, factor,
        dst.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), n_threads)
    return dst


def block_mean_f32(src: np.ndarray, factor: int,
                   n_threads: int = 0) -> np.ndarray:
    lib = _load()
    src = np.ascontiguousarray(src, dtype=np.float32)
    h, w = src.shape
    dst = np.empty((h // factor, w // factor), np.float32)
    lib.block_mean_f32(
        src.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), h, w, factor,
        dst.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), n_threads)
    return dst


def resample_bilinear_f32(src: np.ndarray, dst_h: int, dst_w: int,
                          n_threads: int = 0) -> np.ndarray:
    """Bilinear resample with longitude wrap (equirectangular maps)."""
    lib = _load()
    src = np.ascontiguousarray(src, dtype=np.float32)
    h, w = src.shape
    dst = np.empty((dst_h, dst_w), np.float32)
    lib.resample_bilinear_f32(
        src.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), h, w,
        dst.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), dst_h, dst_w,
        n_threads)
    return dst
