"""Build, declare and launch the port's hand-written CUDA kernels
(csrc/*.cu).

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

A kernel wrapper (a function of ops/) is declared once, where it is
defined, with ``register``: its source, its C entry point and argument
types, its ``__global__`` functions, its plain version and the reference
function it replaces. It launches through ``launch``, the one place that
picks the device and stream, checks the entry point's return code, counts
the launch (the counter ``launch.<wrapper>`` of utils/profiling) and
hands the wrapper's arguments to every active ``recording``.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import hashlib
import importlib
import os
import pkgutil
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Callable, NamedTuple

import torch

from moonrtx_tpu_torch.utils import profiling

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent.parent / "build" / "kernels"
SOURCES = tuple(sorted(p.stem for p in CSRC.glob("*.cu")))
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-Xptxas", "-v", "-shared",
              "-Xcompiler", "-fPIC")
COUNTER = "launch."    # a wrapper's launches: profiling counter COUNTER+name

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


@functools.cache
def entry(source: str, symbol: str, argtypes: tuple,
          restype=ctypes.c_int):
    """The C function ``symbol`` of csrc/<source>.cu's library, with its
    ctypes signature declared once."""
    fn = getattr(lib(source), symbol)
    fn.argtypes = list(argtypes)
    fn.restype = restype
    return fn


class Kernel(NamedTuple):
    """A kernel wrapper's declaration (``register``)."""

    wrapper: Callable
    source: str        # csrc/<source>.cu
    entry: str         # its C entry point ``int entry(args..., stream)``
    argtypes: tuple    # the entry point's arguments before the stream
    passes: tuple      # the __global__ functions one launch runs
    plain: Callable    # the plain PyTorch version, the CPU path
    replaces: str      # the reference function it stands for


_registry: dict = {}   # wrapper name -> Kernel


def register(source: str, entry: str, args, passes: tuple, plain,
             replaces: str):
    """Declare the decorated function a kernel wrapper (returned as it
    is). ``args``: the ctypes Structure its entry point takes by pointer,
    or the tuple of ctypes types it takes by value."""
    if isinstance(args, type) and issubclass(args, ctypes.Structure):
        argtypes = (ctypes.POINTER(args),)
    else:
        argtypes = tuple(args)

    def declare(fn):
        _registry[fn.__name__] = Kernel(fn, source, entry, argtypes,
                                        passes, plain, replaces)
        profiling.count(COUNTER + fn.__name__, 0)
        return fn

    return declare


@functools.cache
def _import_ops() -> None:
    from moonrtx_tpu_torch import ops

    for m in pkgutil.iter_modules(ops.__path__):
        importlib.import_module(f"{ops.__name__}.{m.name}")


def registered() -> dict:
    """{wrapper name: Kernel} of every kernel wrapper; imports every module
    of ops/ once, so each has declared its own."""
    _import_ops()
    return dict(_registry)


def wrappers() -> dict:
    """{name: wrapper} of every kernel wrapper."""
    return {name: k.wrapper for name, k in registered().items()}


def launch(wrapper, args, on: torch.Tensor, call: dict) -> None:
    """Launch ``wrapper``'s kernel on ``on``'s device and current stream:
    ``args`` its argument struct, or the tuple of its arguments by value.
    Raises if the entry point reports a CUDA error; then counts the launch
    and hands ``call`` (the wrapper's arguments by name) to every active
    ``recording``."""
    name = wrapper.__name__
    k = _registry[name]
    fn = entry(k.source, k.entry, k.argtypes + (ctypes.c_void_p,))
    if isinstance(args, ctypes.Structure):
        args = (ctypes.byref(args),)
    stream = ctypes.c_void_p(torch.cuda.current_stream(on.device).cuda_stream)
    with torch.cuda.device(on.device):
        rc = fn(*args, stream)
    if rc != 0:
        msg = lib(k.source).mrtx_error_string(rc).decode()
        raise RuntimeError(f"CUDA kernel {name} ({k.source}.cu) failed: "
                           f"{msg} ({rc})")
    profiling.count(COUNTER + name)
    for calls in _recorders:
        calls.append((name, call))


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


def reset_launch_counts() -> None:
    profiling.reset(COUNTER)


def launch_counts() -> dict:
    """{wrapper name: launches of its kernel} of every kernel wrapper, 0
    for one that never launched; a launch counts only on the card."""
    names = registered()             # first: its imports add the counters
    c = profiling.counters()
    return {name: c[COUNTER + name] for name in names}
