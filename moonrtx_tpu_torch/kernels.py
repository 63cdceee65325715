"""Build and load the port's hand-written CUDA kernels (csrc/*.cu).

Each source is compiled by ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface, loaded with ctypes (no PyTorch headers, so a
build takes seconds). All sources compile in parallel, one ``nvcc``
process each, at first use. The libraries land in ``build/kernels/<key>/``
under the repository root, keyed by a hash of the sources and flags, so a
source change rebuilds and an unchanged tree reuses the build.

``-fmad=false`` keeps every multiply and add separately rounded, as the
plain PyTorch versions and the JAX reference compute them (window
extraction must be bit-exact, and the march's brackets follow the same
roundings as its plain version).
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent.parent / "build" / "kernels"
SOURCES = ("extract", "resample", "shadow_prefix", "march_shade", "bounce")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-Xptxas", "-v", "-shared",
              "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_libs: dict = {}
_recorders: list = []
build_log: dict = {}   # source name -> nvcc output (ptxas register report)
build_seconds: float = 0.0


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only on "
                           "a machine with the CUDA toolkit")
    return path


def _key() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build_all() -> dict:
    """Compile every kernel source (in parallel) and load the libraries.
    Returns {name: ctypes.CDLL}. Raises with the compiler output when a
    build fails."""
    global build_seconds
    with _lock:
        if _libs:
            return _libs
        t0 = time.time()
        out_dir = BUILD_ROOT / _key()
        out_dir.mkdir(parents=True, exist_ok=True)
        todo = [n for n in SOURCES if not (out_dir / f"lib{n}.so").exists()]
        procs = {}
        for name in todo:
            tmp = out_dir / f"lib{name}.{os.getpid()}.tmp.so"
            cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
                   str(CSRC / f"{name}.cu")]
            procs[name] = (subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True), tmp)
        failed = []
        for name, (proc, tmp) in procs.items():
            out, _ = proc.communicate()
            build_log[name] = out
            if proc.returncode != 0:
                failed.append(f"--- {name}.cu ---\n{out}")
            else:
                os.replace(tmp, out_dir / f"lib{name}.so")
        if failed:
            raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
        for name in SOURCES:
            lib = ctypes.CDLL(str(out_dir / f"lib{name}.so"))
            lib.mrtx_error_string.argtypes = [ctypes.c_int]
            lib.mrtx_error_string.restype = ctypes.c_char_p
            _libs[name] = lib
        build_seconds = time.time() - t0
        return _libs


def lib(name: str):
    return build_all()[name]


def entry(name: str, symbol: str, args_struct):
    """The C entry point ``int symbol(const Args*, cudaStream_t)`` of a
    kernel library, with its ctypes signature declared."""
    fn = getattr(lib(name), symbol)
    fn.argtypes = [ctypes.POINTER(args_struct), ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def stream_of(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def check(name: str, rc: int) -> None:
    """Raise if a kernel's C entry point reported a CUDA error."""
    if rc != 0:
        msg = lib(name).mrtx_error_string(rc).decode()
        raise RuntimeError(f"CUDA kernel {name} failed: {msg} ({rc})")


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def launched(wrapper, call: dict) -> None:
    """Count one launch of ``wrapper``'s kernel; ``call`` (the wrapper's
    arguments by name) goes to every active ``recording``."""
    wrapper.launches += 1
    for calls in _recorders:
        calls.append((wrapper.__name__, call))


@contextlib.contextmanager
def recording():
    """Collect (wrapper name, arguments) of every kernel launch made inside
    the block, so a harness can replay a run's launches (kernel against
    plain version, timing) at the shapes the run gave them."""
    calls: list = []
    _recorders.append(calls)
    try:
        yield calls
    finally:
        _recorders.remove(calls)


def wrappers() -> dict:
    """{name: wrapper} of every kernel wrapper; each carries an integer
    ``launches`` count, bumped only where it launches its kernel."""
    from moonrtx_tpu_torch.ops import (extract, march_shade, shadow_prefix,
                                       shadow_scan)

    return {
        "extract_group_windows": extract.extract_group_windows,
        "extract_level_windows": extract.extract_level_windows,
        "resample_group_windows": extract.resample_group_windows,
        "shadow_factor": shadow_prefix.shadow_factor,
        "march_shade": march_shade.march_shade,
        "march_burst": march_shade.march_burst,
        "bounce_from_parts": shadow_scan.bounce_from_parts,
    }


def reset_launch_counts() -> None:
    for fn in wrappers().values():
        fn.launches = 0


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in wrappers().items()}
