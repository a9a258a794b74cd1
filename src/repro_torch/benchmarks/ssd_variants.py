"""Design variants of the ``ssd_scan`` kernel, timed on the card.

Each variant is the committed ``csrc/ssd_scan.cu`` with one change, built
into its own library:

* ``committed`` — as shipped;
* ``single_tf32`` — one TF32 pass per product (a_hi b_hi) in place of the
  hi + lo split's three;
* ``truncated_split`` — the hi and lo parts truncated to TF32 (one bit mask)
  in place of rounded to nearest;
* ``cvt_rna_split`` — the parts rounded by ``cvt.rna.tf32.f32`` in place of
  the two integer operations that round the same way;
* ``one_sum`` — all three parts of a product into one sum, in place of the
  a_hi b_hi parts in a sum apart from the small ones;
* ``exp_every_element`` — M's decay as exp(cum_t - cum_s) for every element
  below the diagonal blocks too, in place of the per-warp table of
  exp(cum_r0 - cum_s) and exp(cum_t - cum_r0) applied once to the sum;
* ``one_buffer`` — a head's x and S_in copied after the last head is done,
  in place of double-buffering them behind its products;
* ``four_heads`` — at most 4 heads per block (C.B^T shared 4 ways) in place
  of 8.

For each it prints, per shape, the error against the chunked twin as a
fraction of max|y| (``chip_smoke.py`` phase 3 holds the committed kernel to
1e-5) and the device time of one call with the L2 cache flushed (CUDA
events around each call, the calls queued behind a sleep so host launch
time is not counted; median of 15 calls in each of two rounds, variants in
turns), and the device time of each of its three launches (state, pass,
chunk) from the profiler; then the largest |kernel - chunked twin| over 20
draws of the reference's decay extremes (dt 5, A (-8, -0.001), |y| in the
hundreds), which phase 3 and the card's tests hold to 5e-4.  Then ``mma_sync_peak``: the rate of
``mma.sync.m16n8k8`` in TF32 alone (8 warps an SM, 8 independent sums a
warp), the ceiling of the route the kernel's products take.  Shapes:
zamba2-7b's layer (2, 2048, 112, 64, 64, 128) and mamba2-130m's (1, 2048,
24, 64, 128, 128).  With ``--baseline ROOT`` the kernel of another checkout
(e.g. the parent commit's unpacked tree) is timed as one more variant, and
its output at each shape held bitwise to the committed kernel's.  Each
variant edits ``ssd_scan.cu`` with ``tf32_split.cuh`` inlined.  Needs
``nvcc`` and a card::

    PYTHONPATH=src python -m repro_torch.benchmarks.ssd_variants [--baseline ROOT]
"""
from __future__ import annotations

import argparse
import ctypes
import subprocess
from pathlib import Path

import torch

from ..kernels._build import BUILD_DIR, CSRC_DIR, CudaKernel, build_all, stream_handle
from ..kernels.ssd_scan.ref import ssd_chunked_ref
from ..kernels.ssd_scan.ssd_scan import _ARGS, launch
from .flash_variants import _times_us
from .stream_variants import _edit, _inline

__all__ = ["VARIANTS", "SHAPES", "run"]

_PARTS = ("  if (part == 0)\n    mma(small, a.lo, b.hi[0], b.hi[1]);\n"
          "  else if (part == 1)\n    mma(small, a.hi, b.lo[0], b.lo[1]);\n  else\n")
_ROUND = "  return (__float_as_uint(v) + 0x1000u) & 0xffffe000u;"
_CVT_RNA = '  uint32_t r;\n  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(v));\n  return r;'
_BELOW = ("          mma_part(yo[mi][j], ys[mi][j], fa[mi], fb[j], part);\n"
          "        else if (mode == 2)")
VARIANTS = {
    "committed": [],
    "single_tf32": [(_PARTS, "  if (part == 2)\n")],
    "truncated_split": [(_ROUND, "  return __float_as_uint(v) & 0xffffe000u;")],
    "cvt_rna_split": [(_ROUND, _CVT_RNA)],
    "one_sum": [("    mma(small, a.lo", "    mma(big, a.lo"), ("    mma(small, a.hi", "    mma(big, a.hi")],
    "exp_every_element": [
        ("        av[e] = raw.cb[mi][e] * raw.e[mi][e];",
         "        av[e] = raw.cb[mi][e] * expf(w.cw[r] - w.cw[s]);"),
        (_BELOW, _BELOW.replace("yo[mi][j], ys[mi][j]", "yd[mi][j], yd[mi][j]"))],
    "one_buffer": [("(4 * state_floats(Lp, dhp, dsp, 2) + 1024) <= kSmemPerSM ? 2 : 1",
                    "(4 * state_floats(Lp, dhp, dsp, 2) + 1024) <= 0 ? 2 : 1"),
                   ("4 * chunk_floats(Lp, dhp, dsp, 2) <= kSmemPerBlock ? 2 : 1",
                    "4 * chunk_floats(Lp, dhp, dsp, 2) <= 0 ? 2 : 1")],
    "four_heads": [("constexpr int kMaxG = 8;", "constexpr int kMaxG = 4;")],
}
SHAPES = ((2, 2048, 112, 64, 64, 128), (1, 2048, 24, 64, 128, 128))
_LAUNCHES = ("state", "pass", "chunk")

_PEAK_SOURCE = r"""
#include <cuda_runtime.h>
#include <stdint.h>
namespace {
__global__ void mma_sync_peak(float* out, int iters) {
  float acc[8][4] = {};
  const uint32_t a0 = threadIdx.x, a1 = 1, a2 = 2, a3 = 3, b0 = 5, b1 = 7;
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j)
      asm volatile(
          "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
          "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
          : "+f"(acc[j][0]), "+f"(acc[j][1]), "+f"(acc[j][2]), "+f"(acc[j][3])
          : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
  }
  float s = 0.f;
  for (int j = 0; j < 8; ++j) s += acc[j][0] + acc[j][1] + acc[j][2] + acc[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
}  // namespace
extern "C" int mma_peak(void* out, int blocks, int threads, int iters, void* stream) {
  mma_sync_peak<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(out), iters);
  return static_cast<int>(cudaGetLastError());
}
extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
"""


def edited_source(name: str) -> str:
    """The committed ``ssd_scan.cu``, ``tf32_split.cuh`` inlined, with
    ``name``'s edits applied."""
    source = _inline((CSRC_DIR / "ssd_scan.cu").read_text(),
                     {"tf32_split.cuh": (CSRC_DIR / "tf32_split.cuh").read_text()})
    return _edit(source, VARIANTS[name], f"variant {name}")


def _kernels(baseline=None):
    """One CudaKernel per variant (its source written under the build dir),
    the baseline's when given, and the mma.sync peak kernel."""
    (BUILD_DIR / "variants").mkdir(parents=True, exist_ok=True)
    kernels = {}
    for name in VARIANTS:
        path = BUILD_DIR / "variants" / f"ssd_scan_{name}.cu"
        path.write_text(edited_source(name))
        kernels[name] = CudaKernel(f"ssd_{name}", path, {"ssd_scan_f32": _ARGS})
    if baseline is not None:
        path = Path(baseline).resolve() / "src" / "repro_torch" / "csrc" / "ssd_scan.cu"
        kernels["baseline"] = CudaKernel("ssd_baseline", path, {"ssd_scan_f32": _ARGS})
    path = BUILD_DIR / "variants" / "mma_sync_peak.cu"
    path.write_text(_PEAK_SOURCE)
    peak_args = [ctypes.c_void_p] + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    peak = CudaKernel("mma_sync_peak", path, {"mma_peak": peak_args})
    return kernels, peak


def _launch_us(fn, reps: int = 5):
    """Device us of each of the kernel's three launches, per call."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = dict.fromkeys(_LAUNCHES, 0.0)
    for ev in prof.events():
        for name in _LAUNCHES:
            if f"ssd_scan_kernel_{name}" in ev.name:
                out[name] += ev.time_range.elapsed_us() / reps
    return out


def _extremes_err(kernel, draws: int = 20) -> float:
    """Largest |kernel - chunked twin| over draws of the reference's decay
    extremes: (1, 128, 2, 8, 16) at chunk 64, dt 5, A (-8, -0.001)."""
    gen = torch.Generator(device="cuda").manual_seed(99)
    dt = torch.full((1, 128, 2), 5.0, device="cuda")
    A = torch.tensor([-8.0, -0.001], device="cuda")
    worst = 0.0
    for _ in range(draws):
        x = torch.randn(1, 128, 2, 8, generator=gen, device="cuda")
        B, C = (torch.randn(1, 128, 16, generator=gen, device="cuda") for _ in range(2))
        y = torch.empty_like(x)
        launch(kernel, x, dt, A, B, C, y, 64)
        twin = ssd_chunked_ref(x, dt, A, B, C, chunk=64)[0]
        worst = max(worst, (y - twin).abs().max().item())
    return worst


def _peak_tflops(peak) -> float:
    """TF32 TFLOP/s of mma.sync alone: 8 warps on every SM."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = torch.empty(sms * 256, device="cuda")
    iters = 4000
    peak.launch("mma_peak", ctypes.c_void_p(out.data_ptr()), sms, 256, 10, stream_handle(out))
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    peak.launch("mma_peak", ctypes.c_void_p(out.data_ptr()), sms, 256, iters,
                stream_handle(out))
    end.record()
    torch.cuda.synchronize()
    flops = sms * 8 * iters * 8 * 2 * 16 * 8 * 8
    return flops / (start.elapsed_time(end) * 1e-3) / 1e12


def run(baseline=None) -> None:
    if not torch.cuda.is_available():
        raise SystemExit("ssd_variants times the CUDA kernel: no card here")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True)
    print(f"card: {card.stdout.strip()}", flush=True)
    kernels, peak = _kernels(baseline)
    print(f"built {len(kernels) + 1} libraries in "
          f"{build_all(list(kernels.values()) + [peak]):.2f} s", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(16)
    flush_buf = torch.empty(64 * 2**20, device="cuda")
    print("variant,shape,err_of_max_y,flushed_us,state_us,pass_us,chunk_us", flush=True)
    for shape in SHAPES:
        b, l, h, dh, ds, chunk = shape
        draw = lambda *sh: torch.randn(*sh, generator=gen, device="cuda")  # noqa: E731
        xs = (draw(b, l, h, dh), torch.nn.functional.softplus(draw(b, l, h)) * 0.1,
              -torch.exp(draw(h)), draw(b, l, ds), draw(b, l, ds))
        want = ssd_chunked_ref(*xs, chunk=chunk)[0]
        y = torch.empty_like(xs[0])
        times = {name: [] for name in kernels}
        for name in list(kernels) + list(kernels)[::-1]:
            fn = lambda: launch(kernels[name], *xs, y, chunk)  # noqa: E731
            fn()
            times[name] += _times_us(fn, flush_buf, flush=True)
        outs = {}
        for name, kernel in kernels.items():
            launch(kernel, *xs, y, chunk)
            outs[name] = y.clone()
            err = ((y - want).abs().max() / want.abs().max()).item()
            parts = _launch_us(lambda: launch(kernel, *xs, y, chunk))
            med = sorted(times[name])[len(times[name]) // 2]
            print(f"{name},{shape},{err:.3e},{med:.2f},"
                  + ",".join(f"{parts[p]:.2f}" for p in _LAUNCHES), flush=True)
        if "baseline" in outs:
            print(f"baseline,{shape},bitwise equal to committed: "
                  f"{torch.equal(outs['baseline'], outs['committed'])}", flush=True)
    print("variant,decay extremes: max |kernel - twin| over 20 draws", flush=True)
    for name, kernel in kernels.items():
        print(f"{name},{_extremes_err(kernel):.3e}", flush=True)
    print(f"mma_sync_peak,TF32 m16n8k8,{_peak_tflops(peak):.1f} TFLOP/s", flush=True)


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--baseline", help="root of another checkout whose ssd_scan.cu "
                        "is timed beside these and held bitwise to the committed one")
    run(parser.parse_args().baseline)
