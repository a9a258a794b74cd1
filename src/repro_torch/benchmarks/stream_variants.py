"""Design variants of the streaming kernels ``axpy_chain`` and
``increment_pre``, timed on the card beside ``torch.add``.

Each variant is the committed ``csrc/stream.cuh`` (the stream both kernels
share) with one change, built with each kernel's source into libraries of its
own:

* ``committed`` — as shipped: 256-thread blocks, each thread loading one
  16-byte vector of every input stream before any arithmetic, one tile a
  block and no loop, the tail in the last block, 64-bit indices, loads and
  stores with the default cache policy, ``axpy_chain`` specialised for its
  chain length s;
* ``vecs_2``, ``vecs_4`` — 2 or 4 vectors a thread per stream, all loaded
  before any arithmetic (more loads in flight, fewer blocks);
* ``threads_128``, ``threads_512`` — 128- or 512-thread blocks;
* ``index_32`` — 32-bit indices (the sizes here fit);
* ``grid_264``, ``grid_1056`` — the grid capped at 2 and 8 blocks per SM
  (2 blocks, and one full wave at 8 resident blocks, over the 132 SMs), each
  block looping over tiles;
* ``ld_streaming``, ``ld_no_allocate`` — inputs loaded as streaming, evict
  first (``ld.global.cs``), or through the non-coherent path without
  allocating in L1 (``ld.global.nc.L1::no_allocate``);
* ``st_evict_first`` — outputs stored as streaming (``st.global.cs``);
* ``baseline`` (with ``--baseline ROOT``) — the kernels of another checkout
  at ``ROOT``, e.g. the parent commit's unpacked tree: its
  ``csrc/axpy_chain.cu`` and ``csrc/increment_pre.cu`` as they are.

For each kernel, size n (4,096: one Table-1 batch; 1,048,576: the served
state; 16,777,216: three 64 MiB streams, past the 50 MB L2) and chain length
s (``axpy_chain``: 1, 2, 4, 8) it prints one CSV row per variant and one for
the library: ``torch.add(w, f, alpha=h)`` for ``increment_pre``, the chain of
s ``torch.add(acc, inc, alpha=c)`` calls for ``axpy_chain``: device us per
call from the profiler's kernel records, as ``chip_smoke.py`` phase 3 takes
them — 20 calls with the L2 flushed before each, then 20 warm (back to
back) — median of 3 rounds, variants in turns, beside the byte bound (each
input read once, the output written once, at 3.35 TB/s) and the flushed
share of it.  ``bitwise`` says
whether the variant equals the plain twin bitwise at every checked shape:
float32 and float64, n = 4,096, 1,048,576, 1,000,003 and 1,000,003 at an
unaligned offset, ``increment_pre`` and ``axpy_chain`` at s = 1..8 (the
baseline's chains too).  Last, the host us per call at 4,096 elements of
each wrapper and of ``torch.add``, in a process of its own for this tree (and
the baseline's), and of the pieces of this tree's ``axpy_chain`` wrapper.
Needs ``nvcc`` and a card::

    PYTHONPATH=src python -m repro_torch.benchmarks.stream_variants [--baseline ROOT]
"""
from __future__ import annotations

import argparse
import ctypes
import inspect
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

from ..kernels._build import (BUILD_DIR, CSRC_DIR, CudaKernel, build_all, cuda_operands,
                              is_current, stream_handle)
from ..kernels.sde_step import ref as sref
from ..kernels.sde_step.sde_step import AXPY_CHAIN, INCREMENT_PRE, MAX_INCS

__all__ = ["VARIANTS", "SIZES", "CHAINS", "host_us_per_call", "run"]

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
SIZES = (4096, 1 << 20, 1 << 24)
CHAINS = (1, 2, 4, 8)
H = 0.25
COEFFS = tuple((-1) ** k * (k + 1) / 7 for k in range(MAX_INCS))

_LOAD = "  x = *reinterpret_cast<const Vec<T, W>*>(p);"
_STORE = "  *reinterpret_cast<Vec<T, W>*>(p) = x;"
_STORE_CS = ("  if constexpr (sizeof(x) == 16) {\n"
             "    __stcs(reinterpret_cast<float4*>(p), *reinterpret_cast<const float4*>(&x));\n"
             "  } else {\n    __stcs(p, x.v[0]);\n  }")
_ONE_PASS = "  map_tile<W>(s, op, static_cast<Index>(blockIdx.x), n_vec, n);"
_LOOP = ("  constexpr Index kTile = static_cast<Index>(kThreads) * kVecs;\n"
         "  for (Index b = blockIdx.x; b == 0 || b * kTile < n_vec; b += gridDim.x)\n"
         "    map_tile<W>(s, op, b, n_vec, n);")
_GRID = "return static_cast<unsigned>(b < 1 ? 1 : b);"


def _vecs(k):
    return [("constexpr int kVecs = 1;", f"constexpr int kVecs = {k};")]


def _load_ptx(op):
    """The load as PTX ``op`` on 32- or 64-bit lanes, for any vector width."""
    return [(_LOAD, f"""  if constexpr (sizeof(x) == 16) {{
    uint32_t u[4];
    asm volatile("{op}.v4.u32 {{%0, %1, %2, %3}}, [%4];"
                 : "=r"(u[0]), "=r"(u[1]), "=r"(u[2]), "=r"(u[3]) : "l"(p));
    __builtin_memcpy(&x, u, 16);
  }} else if constexpr (sizeof(x) == 8) {{
    uint64_t u;
    asm volatile("{op}.u64 %0, [%1];" : "=l"(u) : "l"(p));
    __builtin_memcpy(&x, &u, 8);
  }} else {{
    uint32_t u;
    asm volatile("{op}.u32 %0, [%1];" : "=r"(u) : "l"(p));
    __builtin_memcpy(&x, &u, 4);
  }}""")]


def _threads(k):
    return [("constexpr int kThreads = 256;", f"constexpr int kThreads = {k};")]


def _capped(blocks):
    return [(_ONE_PASS, _LOOP),
            (_GRID, f"return static_cast<unsigned>(b < 1 ? 1 : b < {blocks} ? b : {blocks});")]


# Edits of csrc/stream.cuh, one design choice each.
VARIANTS = {
    "committed": [],
    "vecs_2": _vecs(2),
    "vecs_4": _vecs(4),
    "threads_128": _threads(128),
    "threads_512": _threads(512),
    "index_32": [("using Index = int64_t;", "using Index = int32_t;")],
    "grid_264": _capped(264),
    "grid_1056": _capped(1056),
    "ld_streaming": _load_ptx("ld.global.cs"),
    "ld_no_allocate": _load_ptx("ld.global.nc.L1::no_allocate"),
    "st_evict_first": [(_STORE, _STORE_CS)],
}
_KERNELS = ("axpy_chain", "increment_pre")
_P, _N, _D = ctypes.c_void_p, ctypes.c_int64, ctypes.c_double
_BASELINE_AXPY = {"axpy_chain_f32": [_P, ctypes.POINTER(_P), ctypes.POINTER(_D),
                                     ctypes.c_int, _P, _N, _P],
                  "axpy_chain_f64": [_P, ctypes.POINTER(_P), ctypes.POINTER(_D),
                                     ctypes.c_int, _P, _N, _P]}


def _edit(text: str, edits, what: str) -> str:
    for old, new in edits:
        if old not in text:
            raise ValueError(f"{what}: {old!r} is not in the source")
        text = text.replace(old, new)
    return text


def _inline(source: str, headers) -> str:
    """``source`` with each ``#include "<name>"`` of ``headers`` (name ->
    text) replaced by the header's text, recursively."""
    for name, text in headers.items():
        source = source.replace(f'#include "{name}"', _inline(text, {
            k: v for k, v in headers.items() if k != name}))
    return source


def _variant_kernels(baseline):
    """{variant: {kernel name: CudaKernel}}, each source self-contained
    (headers inlined) under the build dir, its kernels renamed
    ``<kernel>_kernel_<variant>`` so the profiler tells them apart."""
    out_dir = BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    elementwise = (CSRC_DIR / "elementwise.cuh").read_text()
    stream = (CSRC_DIR / "stream.cuh").read_text()
    built = {}
    for variant, edits in VARIANTS.items():
        headers = {"stream.cuh": _edit(stream, edits, variant),
                   "elementwise.cuh": elementwise}
        built[variant] = {}
        for name in _KERNELS:
            text = _inline((CSRC_DIR / f"{name}.cu").read_text(), headers)
            path = out_dir / f"{name}_{variant}.cu"
            path.write_text(text.replace(f"{name}_kernel", f"{name}_kernel_{variant}"))
            fns = AXPY_CHAIN.functions if name == "axpy_chain" else INCREMENT_PRE.functions
            built[variant][name] = CudaKernel(f"stream_{variant}_{name}", path, fns)
    if baseline is not None:
        csrc = Path(baseline) / "src" / "repro_torch" / "csrc"
        headers = {"elementwise.cuh": (csrc / "elementwise.cuh").read_text()}
        built["baseline"] = {}
        for name in _KERNELS:
            text = _inline((csrc / f"{name}.cu").read_text(), headers)
            path = out_dir / f"{name}_baseline.cu"
            path.write_text(text.replace(f"{name}_kernel", f"{name}_kernel_baseline"))
            fns = _BASELINE_AXPY if name == "axpy_chain" else INCREMENT_PRE.functions
            built["baseline"][name] = CudaKernel(f"stream_baseline_{name}", path, fns)
    return built


_SFX = {torch.float32: "f32", torch.float64: "f64"}


def _axpy(kernel, baseline, y, incs, coeffs, out):
    s, sfx = len(incs), _SFX[y.dtype]
    ptrs = [t.data_ptr() for t in incs]
    if baseline:
        kernel.launch(f"axpy_chain_{sfx}", y.data_ptr(), (_P * s)(*ptrs),
                      (_D * s)(*coeffs), s, out.data_ptr(), y.numel(), stream_handle(y))
    else:
        kernel.launch(f"axpy_chain_{sfx}_s{s}", y.data_ptr(), out.data_ptr(),
                      y.numel(), stream_handle(y), *ptrs, *coeffs)


def _increment(kernel, f, w, out):
    kernel.launch(f"increment_pre_{_SFX[f.dtype]}", f.data_ptr(), w.data_ptr(),
                  out.data_ptr(), f.numel(), H, stream_handle(f))


def _call(variant, kernels, name, xs, s, out):
    """One launch of ``variant``'s ``name`` kernel on the inputs ``xs``."""
    if name == "increment_pre":
        _increment(kernels[name], xs[0], xs[1], out)
    else:
        _axpy(kernels[name], variant == "baseline", xs[0], xs[1:s + 1], COEFFS[:s], out)


def _twin(name, xs, s):
    if name == "increment_pre":
        return sref.increment_pre_ref(xs[0], xs[1], H)
    return sref.axpy_chain_ref(xs[0], xs[1:s + 1], COEFFS[:s])


def _library(name, xs, s):
    """The PyTorch call(s) computing the same function: one ``torch.add``, or
    the chain of ``s``."""
    if name == "increment_pre":
        return lambda: torch.add(xs[1], xs[0], alpha=H)

    def chain():
        acc = xs[0]
        for c, inc in zip(COEFFS[:s], xs[1:s + 1]):
            acc = torch.add(acc, inc, alpha=c)
        return acc
    return chain


def _inputs(gen, count, n, dtype, offset=0):
    return [torch.randn(n + offset, generator=gen, device="cuda", dtype=dtype)[offset:]
            for _ in range(count)]


def _bitwise(built):
    """{variant: list of the (kernel, dtype, n, offset, s) cases that differ
    from the twin}, over every checked shape."""
    gen = torch.Generator(device="cuda").manual_seed(17)
    bad = {variant: [] for variant in built}
    for dtype in (torch.float32, torch.float64):
        for n, offset in ((4096, 0), (1 << 20, 0), (1_000_003, 0), (1_000_003, 1)):
            xs = _inputs(gen, MAX_INCS + 1, n, dtype, offset)
            out = torch.empty(n, device="cuda", dtype=dtype)
            cases = [("increment_pre", 1)] + [("axpy_chain", s) for s in range(1, MAX_INCS + 1)]
            for name, s in cases:
                want = _twin(name, xs, s)
                for variant, kernels in built.items():
                    out.fill_(float("nan"))
                    _call(variant, kernels, name, xs, s, out)
                    if not torch.equal(out, want):
                        bad[variant].append((name, str(dtype)[6:], n, offset, s))
    return bad


def _device_us(fn, match, flush_buf, reps: int = 20):
    """Device us per call of ``fn``'s kernels whose name contains ``match``
    (every kernel but the flush when None), from the profiler over ``reps``
    calls, the L2 flushed before each when ``flush_buf`` is given."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            if flush_buf is not None:
                flush_buf.zero_()
            fn()
        torch.cuda.synchronize()
    total = 0.0
    for ev in prof.events():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        if "FillFunctor" in ev.name or ev.name.startswith("Memset"):
            continue  # the L2 flush
        if match is None or match in ev.name:
            total += ev.time_range.elapsed_us()
    return total / reps


def _times(calls, flush_buf, rounds: int = 3):
    """{label: (flushed us, warm us)}, each the median over ``rounds`` of a
    flushed then a warm measurement of one ``(label, fn, match)`` call, the
    calls in turns (reversed every other round)."""
    got = {label: ([], []) for label, _, _ in calls}
    for r in range(rounds):
        for label, fn, match in (calls if r % 2 == 0 else calls[::-1]):
            got[label][0].append(_device_us(fn, match, flush_buf))
            got[label][1].append(_device_us(fn, match, None))
    med = lambda xs: sorted(xs)[len(xs) // 2]  # noqa: E731
    return {label: (med(f), med(w)) for label, (f, w) in got.items()}


def host_us_per_call(fn, reps: int = 2000, rounds: int = 5) -> float:
    """Median host us per call of ``fn`` over ``rounds`` rounds of ``reps``
    back-to-back calls (the device keeps up at the sizes this is used for),
    synchronized between rounds."""
    for _ in range(50):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        start = time.perf_counter()
        for _ in range(reps):
            fn()
        times.append((time.perf_counter() - start) / reps * 1e6)
        torch.cuda.synchronize()
    return sorted(times)[rounds // 2]


_HOST_SCRIPT = """
import json, sys, time, torch
sys.path.insert(0, sys.argv[1])
from repro_torch.kernels.sde_step.sde_step import axpy_chain, increment_pre
{timer}
n = int(sys.argv[2])
gen = torch.Generator(device="cuda").manual_seed(4)
y, inc = (torch.randn(n, generator=gen, device="cuda") for _ in range(2))
print(json.dumps({{
    "axpy_chain": host_us_per_call(lambda: axpy_chain(y, [inc], [0.5])),
    "increment_pre": host_us_per_call(lambda: increment_pre(y, inc, 0.25)),
    "torch.add": host_us_per_call(lambda: torch.add(y, inc, alpha=0.5))}}))
"""

def _host_row(src: Path, n: int):
    """Host us per call of the wrappers of the package under ``src`` (and
    of ``torch.add``), timed by :func:`host_us_per_call` in a process of
    their own."""
    code = _HOST_SCRIPT.format(timer=inspect.getsource(host_us_per_call))
    proc = subprocess.run([sys.executable, "-c", code, str(src), str(n)],
                          capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"host timing under {src} failed:\n{proc.stderr}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def _host_pieces(n: int):
    """Host us per call of the pieces of one ``axpy_chain`` call at s = 1."""
    y, inc = (torch.randn(n, device="cuda") for _ in range(2))
    out, stream = torch.empty_like(y), stream_handle(y)
    launch = lambda: AXPY_CHAIN.launch(  # noqa: E731
        "axpy_chain_f32_s1", y.data_ptr(), out.data_ptr(), n, stream, inc.data_ptr(), 0.5)
    return {"cuda_operands(y, inc)": host_us_per_call(lambda: cuda_operands(y, inc)),
            "torch.empty_like(y)": host_us_per_call(lambda: torch.empty_like(y)),
            "stream_handle(y)": host_us_per_call(lambda: stream_handle(y)),
            "is_current(y)": host_us_per_call(lambda: is_current(y)),
            "AXPY_CHAIN.launch (ctypes call, counted)": host_us_per_call(launch)}


def run(baseline=None) -> None:
    if not torch.cuda.is_available():
        raise SystemExit("stream_variants times the CUDA kernels: no card here")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True)
    print(f"card: {card.stdout.strip()}", flush=True)
    built = _variant_kernels(baseline)
    libs = [k for kernels in built.values() for k in kernels.values()]
    print(f"built {len(libs)} libraries in {build_all(libs):.2f} s", flush=True)
    variants = list(built)
    bad = _bitwise(built)
    for variant in variants:
        print(f"bitwise {variant}: {'all equal' if not bad[variant] else bad[variant]}",
              flush=True)
    gen = torch.Generator(device="cuda").manual_seed(16)
    flush_buf = torch.empty(256 * 2**20 // 4, device="cuda")
    print("kernel,n,s,variant,bitwise,flushed_us,warm_us,bound_us,share_flushed", flush=True)
    cases = [("increment_pre", 1)] + [("axpy_chain", s) for s in CHAINS]
    for n in SIZES:
        for name, s in cases:
            xs = _inputs(gen, s + 1, n, torch.float32)
            out = torch.empty(n, device="cuda")
            lib = ("torch.add" if name == "increment_pre" or s == 1
                   else f"torch.add x{s}")
            calls = [(v, (lambda v=v: _call(v, built[v], name, xs, s, out)),
                      f"{name}_kernel_{v}<") for v in variants]
            calls.append((lib, _library(name, xs, s), None))
            times = _times(calls, flush_buf)
            bound = (s + 2) * n * 4 / HBM_BYTES_PER_S * 1e6
            for label, _, _ in calls:
                flushed, warm = times[label]
                exact = "" if label == lib else str(not bad[label])
                print(f"{name},{n},{s},{label},{exact},{flushed:.2f},{warm:.2f},"
                      f"{bound:.2f},{bound / flushed:.1%}", flush=True)
            del xs, out
    src = Path(__file__).resolve().parents[2]
    rows = {"this tree": _host_row(src, 4096)}
    if baseline is not None:
        rows["baseline"] = _host_row(Path(baseline) / "src", 4096)
    print("wrappers,n,axpy_chain_host_us,increment_pre_host_us,torch.add_host_us", flush=True)
    for label, r in rows.items():
        print(f"{label},4096,{r['axpy_chain']:.2f},{r['increment_pre']:.2f},"
              f"{r['torch.add']:.2f}", flush=True)
    print("axpy_chain host piece,n,host_us", flush=True)
    for piece, us in _host_pieces(4096).items():
        print(f"{piece},4096,{us:.2f}", flush=True)


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--baseline", help="root of another checkout whose "
                        "axpy_chain.cu and increment_pre.cu are timed beside these")
    run(parser.parse_args().baseline)
