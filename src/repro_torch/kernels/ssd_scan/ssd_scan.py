"""Chunked Mamba2 SSD scan for Hopper (port of
``repro.kernels.ssd_scan.ssd_scan``).

One CUDA source, ``csrc/ssd_scan.cu``, built by nvcc for ``sm_90a``, run as
three launches behind one C entry: ``ssd_scan_kernel_state`` (each chunk's
state increment and decay, one block per (chunk, batch row, group of heads)
with B loaded once for the group), ``ssd_scan_kernel_pass`` (the chunk-to-
chunk state recurrence, elementwise over (b, h, dh, ds)) and
``ssd_scan_kernel_chunk`` (y of each chunk, with C.B^T formed once per
group of heads).  Every product runs on the tensor cores in TF32 with a
hi + lo split of both operands, which keeps it to float32 accuracy.
float32 in and out; the wrapper allocates the chunk states and decays.
On a CPU tensor :func:`ssd_scan` is its plain twin (``ssd_chunked_ref``);
on a CUDA tensor it launches the kernels or raises.  ``KERNEL.launches``
counts calls of the C entry (one per SSM layer), not the three launches.

:func:`ssd_scan_bwd` is the gradient, from a second source,
``csrc/ssd_scan_bwd.cu`` (``KERNEL_BWD``): six launches (the chunk states
and their pass, the state adjoints and their reverse pass, the within-chunk
gradients, the sums over head groups) behind one C entry.  The chunk states
and adjoints stay float32 arithmetic on the FMA units; the within-chunk
products run on TF32 ``mma.sync`` with the forward's hi + lo split, one
block per (chunk, batch row, group of heads).  On a CPU tensor it is its
twin :func:`~.ref.ssd_bwd_ref`.

Both take the reference's ``interpret=`` keyword: ``interpret=True`` runs
the plain twin on any device, as the reference's Pallas interpret mode
does in its CPU tests.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .._build import CudaKernel, pointer, stream_handle
from .ref import ssd_bwd_ref, ssd_chunked_ref

__all__ = ["KERNEL", "KERNEL_BWD", "BWD_MAX_CHUNK", "BWD_MAX_HEAD_DIM", "BWD_MAX_STATE",
           "bwd_heads_per_block", "bwd_smem_bytes", "sm_count", "ssd_scan", "ssd_scan_bwd",
           "smem_bytes"]

_I = ctypes.c_int
_ARGS = [ctypes.c_void_p] * 8 + [_I] * 6 + [ctypes.c_void_p]
KERNEL = CudaKernel("ssd_scan", "ssd_scan.cu", {"ssd_scan_f32": _ARGS})
_BWD_ARGS = [ctypes.c_void_p] * 17 + [_I] * 7 + [ctypes.c_void_p]
KERNEL_BWD = CudaKernel("ssd_scan_bwd", "ssd_scan_bwd.cu", {"ssd_scan_bwd_f32": _BWD_ARGS})
#: The backward kernel's largest chunk, head dim and state dim (kMaxL,
#: kMaxDh, kMaxDs).
BWD_MAX_CHUNK, BWD_MAX_HEAD_DIM, BWD_MAX_STATE = 128, 64, 128
_BWD_SHARED_DS = 64  # kSharedDs: the largest ds whose C and B stay in shared memory
_BWD_THREADS = 256
_MAX_SMEM = 232448  # the shared memory one Hopper block may use
_SMEM_PER_SM = 233472  # an SM's, 1024 bytes of it reserved per block
_MAX_G, _WARPS = 8, 8  # kMaxG, kWarps in the source


def _pad32(n: int) -> int:
    return -(-n // 32) * 32


def smem_bytes(chunk: int, dh: int, ds: int) -> dict:
    """Dynamic shared memory of the two kernels that use it
    (``state_floats``/``chunk_floats`` with ``state_nbuf``/``chunk_nbuf`` in
    the source): every extent padded to 32, rows strided 4 or 8 floats past
    that; a head's x (and S_in) double-buffered where the state kernel
    still fits twice on an SM and the chunk kernel once."""
    L, dhp, dsp = _pad32(chunk), _pad32(dh), _pad32(ds)

    def state(nbuf):
        return 4 * (L * (dsp + 8) + nbuf * L * (dhp + 8) + _MAX_G * L)

    def chunk_(nbuf):
        b, buf = L * (dsp + 4), L * (dhp + 8) + dhp * (dsp + 4)
        return 4 * (L * (dsp + 4) + L * (L + 4) + 2 * _MAX_G * L + _WARPS * 2 * L
                    + (buf if nbuf == 2 else 0) + max(buf, b))

    return {"state": state(2) if 2 * (state(2) + 1024) <= _SMEM_PER_SM else state(1),
            "chunk": chunk_(2) if chunk_(2) <= _MAX_SMEM else chunk_(1)}


def bwd_smem_bytes(chunk: int, dh: int, ds: int) -> dict:
    """Dynamic shared memory of the backward's launches that use it
    (``outer_floats`` / ``chunk_floats`` in the source): the outer launch's
    dt, cum and weights with the weighted rows and B or C, each padded to 4
    columns; the chunk launch's C.B^T (its lower triangle of 16 x 16 blocks,
    rows strided 20), a head's u and dy, C and B where ds <= 64, a head's
    S_in and G, its dt and cum, dcum's two sides, x.du, the partial sums
    of <G, S> and each warp's table of decays."""
    Lp = -(-chunk // 16) * 16
    dhp, dsp = -(-dh // 8) * 8, -(-ds // 8) * 8
    nb = Lp // 16
    outer = 3 * Lp + Lp * (-(-dh // 4) * 4) + Lp * (-(-ds // 4) * 4)
    chunk_ = (nb * (nb + 1) // 2 * 16 * 20 + 2 * Lp * (dhp + 4)
              + (2 * Lp * (dsp + 4) if ds <= _BWD_SHARED_DS else 0)
              + 2 * dhp * (dsp + 4) + 5 * Lp + _BWD_THREADS + _WARPS * Lp)
    return {"outer": 4 * outer, "chunk": 4 * chunk_}


def bwd_heads_per_block(rows: int, h: int, ds: int, sms: int) -> int:
    """Heads a block of the backward's chunk launch takes: 1 where ds > 64
    (C and B are read through the cache there), else the most, up to 8,
    whose grid of ``rows`` (batch rows x chunks) x ceil(h / G) blocks still
    fills its waves of ``sms`` resident blocks (one an SM) to 90%, as the
    forward's ``heads_per_block``."""
    if ds > _BWD_SHARED_DS:
        return 1
    for G in range(_MAX_G, 1, -1):
        blocks = rows * -(-h // G)
        waves = -(-blocks // sms)
        if 10 * blocks >= 9 * waves * sms:
            return G
    return 1


def _check(name, x, dt, A, B, C, chunk, *others):
    """Checks the operands of a CUDA launch (``others`` shaped as x)."""
    b, l, h, dh = x.shape
    ds = B.shape[-1]
    if l % chunk:
        raise ValueError(f"sequence length {l} is not a multiple of chunk {chunk}")
    if (dt.shape != (b, l, h) or A.shape != (h,) or B.shape != (b, l, ds)
            or C.shape != (b, l, ds) or any(t.shape != x.shape for t in others)):
        raise ValueError(f"shapes x {tuple(x.shape)}, dt {tuple(dt.shape)}, A "
                         f"{tuple(A.shape)}, B {tuple(B.shape)}, C "
                         f"{tuple(C.shape)} do not match")
    for t in (x, dt, A, B, C) + others:
        if t.dtype != torch.float32:
            raise TypeError(f"{name} takes float32, got {t.dtype}")
        if t.device != x.device:
            raise ValueError(f"{name} operands must share one CUDA device")


def ssd_scan(x, dt, A, B, C, *, chunk: int = 128, interpret: bool = False):
    """y (b, l, h, dh) of the chunked scan from a zero state; ``interpret``
    runs the plain twin."""
    b, l, h, dh = x.shape
    ds = B.shape[-1]
    chunk = min(chunk, l)
    if interpret or x.device.type == "cpu":
        return ssd_chunked_ref(x, dt, A, B, C, chunk=chunk)[0]
    if x.device.type != "cuda":
        raise ValueError(f"ssd_scan runs on CUDA or CPU tensors, got {x.device}")
    _check("ssd_scan", x, dt, A, B, C, chunk)
    need = max(smem_bytes(chunk, dh, ds).values())
    if need > _MAX_SMEM:
        raise ValueError(f"chunk {chunk} with dh {dh}, ds {ds} needs {need} bytes "
                         f"of shared memory, more than a block has ({_MAX_SMEM})")
    x, dt, A, B, C = (t.contiguous() for t in (x, dt, A, B, C))
    y = torch.empty_like(x)
    if y.numel() == 0:
        return y
    with torch.cuda.device(x.device):
        launch(KERNEL, x, dt, A, B, C, y, chunk)
    return y


def launch(kernel, x, dt, A, B, C, y, chunk: int) -> torch.Tensor:
    """Launches ``kernel``'s ``ssd_scan_f32`` on checked, contiguous operands
    with its scratch: the chunk states (b, nc, h, dh, ds), increments and
    then in place the state entering each chunk, which it returns, and each
    chunk's decay exp(cum_L)."""
    b, l, h, dh = x.shape
    ds = B.shape[-1]
    states = x.new_empty(b, l // chunk, h, dh, ds)
    decays = x.new_empty(b, l // chunk, h)
    kernel.launch("ssd_scan_f32", pointer(x), pointer(dt), pointer(A), pointer(B),
                  pointer(C), pointer(y), pointer(states), pointer(decays), b, l, h,
                  dh, ds, chunk, stream_handle(x))
    return states


def ssd_scan_bwd(x, dt, A, B, C, dy, *, chunk: int = 128, interpret: bool = False):
    """The gradient ``(dx, ddt, dA, dB, dC)`` of :func:`ssd_scan`'s y against
    the cotangent ``dy`` (the chunk states are recomputed, not taken from
    the forward); ``interpret`` runs the plain twin."""
    b, l, h, dh = x.shape
    ds = B.shape[-1]
    chunk = min(chunk, l)
    if interpret or x.device.type == "cpu":
        return ssd_bwd_ref(x, dt, A, B, C, dy, chunk=chunk)
    if x.device.type != "cuda":
        raise ValueError(f"ssd_scan_bwd runs on CUDA or CPU tensors, got {x.device}")
    _check("ssd_scan_bwd", x, dt, A, B, C, chunk, dy)
    if chunk > BWD_MAX_CHUNK or dh > BWD_MAX_HEAD_DIM or ds > BWD_MAX_STATE:
        raise ValueError(f"ssd_scan_bwd takes chunk <= {BWD_MAX_CHUNK}, head dim <= "
                         f"{BWD_MAX_HEAD_DIM} and state dim <= {BWD_MAX_STATE}, got "
                         f"{chunk}, {dh} and {ds}")
    if ds > _BWD_SHARED_DS and (chunk % 16 or ds % 8):
        raise ValueError(f"ssd_scan_bwd takes a state dim above {_BWD_SHARED_DS} with a "
                         f"chunk a multiple of 16 and a state dim a multiple of 8, got "
                         f"{chunk} and {ds}")
    x, dt, A, B, C, dy = (t.contiguous() for t in (x, dt, A, B, C, dy))
    dx, ddt = torch.empty_like(x), torch.empty_like(dt)
    dA, dB, dC = torch.empty_like(A), torch.empty_like(B), torch.empty_like(C)
    if dx.numel() == 0:
        return dx, ddt, dA.zero_(), dB.zero_(), dC.zero_()
    nc = l // chunk
    heads = bwd_heads_per_block(b * nc, h, ds, sm_count(x.device))
    S = x.new_empty(b, nc, h, dh, ds)  # the chunk states, then beside them
    G = torch.empty_like(S)            # their adjoints, G_{n+1} at slot n
    decay = x.new_empty(b, nc, h)
    dBp = x.new_empty(b, l, -(-h // heads), ds)  # dB and dC summed over each head group
    dCp = torch.empty_like(dBp)
    dAp = x.new_empty(b, nc, h)
    with torch.cuda.device(x.device):
        KERNEL_BWD.launch("ssd_scan_bwd_f32", *(pointer(t) for t in (
            x, dt, A, B, C, dy, dx, ddt, dA, dB, dC, S, G, decay, dBp, dCp, dAp)),
            b, l, h, dh, ds, chunk, heads, stream_handle(x))
    return dx, ddt, dA, dB, dC


@functools.lru_cache(maxsize=None)
def sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count
