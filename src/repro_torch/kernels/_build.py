"""Build the port's CUDA sources with nvcc on first use and bind them with ctypes.

Each kernel source under ``repro_torch/csrc/`` is compiled on its own into a
shared library with a plain C interface (no PyTorch headers, so one build
takes seconds), for ``sm_90a``.  Libraries land in ``csrc/build/`` under a
name that carries a hash of the sources and flags, so an edited source is
rebuilt and an unchanged one is reused; a build writes to a temporary name
and renames it into place, so concurrent builders never load a partial file.

Nothing is compiled or loaded at import time: the CPU tests import every
module, and a machine without ``nvcc`` never reaches a build.
"""
from __future__ import annotations

import concurrent.futures
import ctypes
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

__all__ = ["CudaKernel", "build_all", "cuda_operands", "pointer",
           "stream_handle", "CSRC_DIR", "BUILD_DIR"]

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC_DIR / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


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
    is incremented by the Python wrapper each time it launches the kernel,
    and nowhere else; callers reset it to count the launches of one run.
    """

    def __init__(self, name: str, source: str,
                 functions: Dict[str, Sequence]):
        self.name = name
        self.source = CSRC_DIR / source
        self.functions = dict(functions)
        self.launches = 0
        self.build_log = ""
        self._lib = None
        self._lock = threading.Lock()

    def library_path(self) -> Path:
        digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
        for path in [self.source] + sorted(CSRC_DIR.glob("*.cuh")):
            digest.update(path.read_bytes())
        return BUILD_DIR / f"lib{self.name}-{digest.hexdigest()[:16]}.so"

    def build(self) -> Path:
        """Compile the source unless its library is already built."""
        target = self.library_path()
        if target.exists():
            return target
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC_DIR), "-o", tmp,
               str(self.source)]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True)
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
        """Call the C launcher ``fn``, raise on a CUDA error, count the launch."""
        lib = self.lib()
        code = getattr(lib, fn)(*args)
        if code != 0:
            msg = lib.repro_cuda_error_string(code).decode()
            raise RuntimeError(f"{self.name} kernel launch failed: {msg} "
                               f"(cudaError {code})")
        self.launches += 1


def build_all(kernels: Iterable[CudaKernel]) -> float:
    """Build every kernel's library in parallel (one nvcc each, all started
    together); returns the wall seconds spent."""
    start = time.perf_counter()
    kernels = list(kernels)
    with concurrent.futures.ThreadPoolExecutor(max_workers=max(1, len(kernels))) as pool:
        for fut in [pool.submit(k.build) for k in kernels]:
            fut.result()
    return time.perf_counter() - start


def stream_handle(t: torch.Tensor) -> ctypes.c_void_p:
    """PyTorch's current CUDA stream on ``t``'s device, as a ctypes handle."""
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def pointer(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def cuda_operands(ref: torch.Tensor, *others: torch.Tensor):
    """Check that ``others`` can join ``ref`` in one elementwise launch and
    return them dense: same CUDA device, same float dtype, and broadcastable
    to ``ref``'s shape (broadcast operands are materialized)."""
    if ref.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"kernel takes float32 or float64, got {ref.dtype}")
    out = []
    for t in (ref,) + others:
        if t.device != ref.device:
            raise ValueError(f"operands on {t.device} and {ref.device}")
        if t.dtype != ref.dtype:
            raise TypeError(f"operand dtype {t.dtype} != {ref.dtype}")
        if t.shape != ref.shape:
            t = t.expand(ref.shape)
        out.append(t.contiguous())
    return out
