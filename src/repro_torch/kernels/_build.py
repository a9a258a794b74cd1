"""Build the port's CUDA sources with nvcc on first use and bind them with ctypes.

Each kernel source under ``repro_torch/csrc/`` is compiled on its own into a
shared library with a plain C interface (no PyTorch headers, so one build
takes seconds), for ``sm_90a``.  Libraries land in ``csrc/build/`` (or the
directory :func:`set_library_dir` names: the serving engine's persistent
kernel cache) under a name that carries a hash of the sources and flags, so
an edited source is rebuilt and an unchanged one is reused, by this process
or a later one; a build writes to a temporary name and renames it into
place, so concurrent builds never load a partial file.

Nothing is compiled or loaded at import time: the CPU tests import every
module, and a machine without ``nvcc`` never reaches a build.
"""
from __future__ import annotations

import collections
import concurrent.futures
import contextlib
import ctypes
import gc
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, Sequence

import torch

__all__ = ["CudaKernel", "GraphLaunches", "build_all", "capture_graph", "cuda_operands",
           "is_current",
           "pointer", "stream_handle", "set_library_dir", "CSRC_DIR", "BUILD_DIR"]

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC_DIR / "build"
# Where libraries are built and looked up: process-wide, as the reference's
# persistent compilation cache is jax's process-wide setting.
_library_dir = BUILD_DIR
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# The current stream's handle by device index (what Triton and inductor
# launch on) and the current device's index, read without the Python
# wrappers around them; absent from CPU builds of torch.
_RAW_STREAM = getattr(torch._C, "_cuda_getCurrentRawStream", None)
_CURRENT_DEVICE = getattr(torch._C, "_cuda_getDevice", None)
# The record of the CUDA graph being captured (one capture at a time).
_capture_record = None
_capture_lock = threading.Lock()


def set_library_dir(path) -> None:
    """Build and load kernel libraries under ``path`` from now on.

    Kernels already loaded keep their library; every other kernel looks for
    its library (named by the hash of its sources and flags) in ``path`` and
    builds it there if absent, so a later process pointed at the same
    directory loads it and runs no ``nvcc``."""
    global _library_dir
    _library_dir = Path(path)


def _nvcc() -> str:
    """The nvcc to build with: ``$NVCC``, then ``nvcc`` on PATH, then
    ``$CUDA_HOME/bin/nvcc`` (CUDA_HOME defaulting to /usr/local/cuda)."""
    for cand in (os.environ.get("NVCC"), shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.isfile(cand) and os.access(cand, os.X_OK):
            return cand
    raise RuntimeError(
        "nvcc not found (set NVCC or CUDA_HOME): the port's CUDA kernels are "
        "built from repro_torch/csrc on first use"
    )


class CudaKernel:
    """One CUDA source, built on first use, with its launch count.

    ``functions`` maps each exported C function to its ctypes ``argtypes``
    (every exported function returns a ``cudaError_t`` as int).  ``launches``
    counts the kernel's launches on the device: the Python wrapper adds one
    each time it launches the kernel on a stream that is not being captured,
    and a :class:`GraphLaunches` record adds its captured launches each time
    its CUDA graph is replayed (``replayed_launches`` counts those alone).
    ``host_launches`` counts the wrapper's calls of the C launcher, captured
    ones included: it stays flat while a graph replays.  Callers reset the
    counts to count the launches of one run.  ``entry_launches`` counts the
    device launches by exported function (a kernel's specialisations, its
    routes); callers read it by difference.  ``nvcc_runs`` counts the builds
    this process ran (0 when the library was found built).
    """

    def __init__(self, name: str, source: str,
                 functions: Dict[str, Sequence]):
        self.name = name
        self.source = CSRC_DIR / source
        self.functions = dict(functions)
        self.launches = 0
        self.host_launches = 0
        self.replayed_launches = 0
        self.entry_launches = collections.Counter()
        self.build_log = ""
        self.nvcc_runs = 0
        self._lib = None
        self._bound = {}
        self._lock = threading.Lock()

    def library_path(self) -> Path:
        digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
        for path in [self.source] + sorted(CSRC_DIR.glob("*.cuh")):
            digest.update(path.read_bytes())
        return _library_dir / f"lib{self.name}-{digest.hexdigest()[:16]}.so"

    def build(self) -> Path:
        """Compile the source unless its library is already built."""
        target = self.library_path()
        if target.exists():
            return target
        target.parent.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=target.parent)
        os.close(fd)
        cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC_DIR), "-o", tmp,
               str(self.source)]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True)
            self.nvcc_runs += 1
            self.build_log = proc.stdout + proc.stderr
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed to build {self.source.name} "
                    f"(exit {proc.returncode}):\n{self.build_log}")
            os.replace(tmp, target)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
        return target

    def lib(self) -> ctypes.CDLL:
        """The loaded library (built first if needed)."""
        with self._lock:
            if self._lib is None:
                lib = ctypes.CDLL(str(self.build()))
                for fn, argtypes in self.functions.items():
                    getattr(lib, fn).argtypes = list(argtypes)
                    getattr(lib, fn).restype = ctypes.c_int
                lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
                lib.repro_cuda_error_string.restype = ctypes.c_char_p
                self._lib = lib
            return self._lib

    def launch(self, fn: str, *args) -> None:
        """Call the C launcher ``fn``, raise on a CUDA error, count the launch
        (into the record of the graph being captured, if the current stream
        is capturing one)."""
        func = self._bound.get(fn)
        if func is None:
            func = self._bound.setdefault(fn, getattr(self.lib(), fn))
        code = func(*args)
        if code != 0:
            msg = self._lib.repro_cuda_error_string(code).decode()
            raise RuntimeError(f"{self.name} kernel launch failed: {msg} "
                               f"(cudaError {code})")
        self.host_launches += 1
        record = _capture_record
        if record is not None and torch.cuda.is_current_stream_capturing():
            record.counts[(self, fn)] += 1
            return
        self.launches += 1
        self.entry_launches[fn] += 1


class GraphLaunches:
    """The kernel launches one CUDA graph captured, by kernel and entry.

    A launch made while the graph is captured runs nothing, so the wrapper
    counts it here (``counts[(kernel, entry)]``) and not in the kernel's
    ``launches``; :meth:`replay` adds the record to ``launches``,
    ``replayed_launches`` and ``entry_launches`` each time the graph runs.
    Launches from any thread whose current stream is capturing count
    (autograd runs the backward pass in its own thread)."""

    def __init__(self):
        self.counts = collections.Counter()

    @contextlib.contextmanager
    def capturing(self):
        """Record the launches made on capturing streams while inside."""
        global _capture_record
        with _capture_lock:
            if _capture_record is not None:
                raise RuntimeError("another CUDA graph is being captured")
            _capture_record = self
        try:
            yield self
        finally:
            _capture_record = None

    def by_kernel(self) -> Dict[str, int]:
        """Captured launches by kernel name."""
        out = collections.Counter()
        for (kernel, _), n in self.counts.items():
            out[kernel.name] += n
        return dict(out)

    def replay(self) -> None:
        """Count one replay of the graph."""
        for (kernel, fn), n in self.counts.items():
            kernel.launches += n
            kernel.replayed_launches += n
            kernel.entry_launches[fn] += n


def capture_graph(run, record: GraphLaunches, stream, pool=None):
    """``run()`` captured into a new ``torch.cuda.CUDAGraph`` on ``stream``
    (a stream other than the legacy default one), into the memory pool
    ``pool`` (a private one when None), its kernel launches counted in
    ``record``; returns ``(graph, run's output)``.  Nothing synchronises:
    the capture may run in a worker thread while other threads use the
    device (``thread_local`` capture mode).  Another graph destroyed while
    this one is captured (by the cyclic collector) would invalidate the
    capture, so the collector runs before it and is off during it.  A
    capture that fails raises."""
    graph = torch.cuda.CUDAGraph()
    gc.collect()
    gc_was_enabled = gc.isenabled()
    gc.disable()
    try:
        with record.capturing(), torch.cuda.stream(stream):
            graph.capture_begin(pool=pool, capture_error_mode="thread_local")
            try:
                out = run()
            finally:
                graph.capture_end()
    finally:
        if gc_was_enabled:
            gc.enable()
    return graph, out


def build_all(kernels: Iterable[CudaKernel]) -> float:
    """Build every kernel's library in parallel (one nvcc each, all started
    together); returns the wall seconds spent."""
    start = time.perf_counter()
    kernels = list(kernels)
    with concurrent.futures.ThreadPoolExecutor(max_workers=max(1, len(kernels))) as pool:
        for fut in [pool.submit(k.build) for k in kernels]:
            fut.result()
    return time.perf_counter() - start


def stream_handle(t: torch.Tensor) -> int:
    """PyTorch's current CUDA stream on ``t``'s device, as the integer handle
    a ``c_void_p`` argument takes (read without building a ``Stream``)."""
    if _RAW_STREAM is not None:
        return _RAW_STREAM(t.device.index)
    return torch.cuda.current_stream(t.device).cuda_stream


def is_current(t: torch.Tensor) -> bool:
    """Whether ``t``'s CUDA device is the current one, so a launch on it
    needs no ``torch.cuda.device`` switch."""
    current = _CURRENT_DEVICE() if _CURRENT_DEVICE else torch.cuda.current_device()
    return t.get_device() == current


def real(t: torch.Tensor) -> torch.Tensor:
    """``t``, or ``RuntimeError`` for a fake or meta tensor (no data for a
    kernel to read)."""
    if t.is_meta or type(t).__name__ == "FakeTensor":
        raise RuntimeError(f"a kernel was handed a {type(t).__name__} on {t.device}, "
                           "which has no data (a dry run takes use_flash='never')")
    return t


def pointer(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(real(t).data_ptr())


def cuda_operands(ref: torch.Tensor, *others: torch.Tensor, shapes=None):
    """Check that ``others`` can join ``ref`` in one launch and return them
    dense: same CUDA device, same float dtype, and broadcastable to ``ref``'s
    shape, or to ``shapes[i]`` for operand ``i`` (``ref`` is operand 0) when
    ``shapes`` is given.  Broadcast operands are materialized."""
    dtype, index = ref.dtype, ref.get_device()
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"kernel takes float32 or float64, got {dtype}")
    out = []
    for i, t in enumerate((ref,) + others):
        if t.get_device() != index:  # -1 off CUDA
            raise ValueError(f"operands on {t.device} and {ref.device}")
        if t.dtype != dtype:
            raise TypeError(f"operand dtype {t.dtype} != {dtype}")
        shape = ref.shape if shapes is None else torch.Size(shapes[i])
        if t.shape != shape:
            t = t.expand(shape)
        out.append(t.contiguous())
    return out
