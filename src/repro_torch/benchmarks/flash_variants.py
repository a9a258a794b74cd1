"""Design variants of ``flash_attention``'s tensor-core routes, timed on the card.

Each variant is the committed ``csrc/flash_attention.cu`` with one change,
built into its own library.  The bf16 ``wgmma`` route:

* ``committed`` — as shipped;
* ``p_single_bf16`` — O += P V with P rounded to one bf16 part (the hi
  part alone), one wgmma pass over V instead of two;
* ``mask_every_tile`` — the causal/ragged mask evaluated on every KV tile,
  and ``exp2f`` in place of the SFU's ``ex2.approx.ftz``;
* ``three_stages`` — a K/V ring of three stages instead of two (230 KB of
  shared memory).

The float32 ``mma_tf32`` route:

* ``committed`` — as shipped: 8 warps of 16 q rows (one block an SM), the
  q tile in shared memory split at every step, KV tiles of 64 rows, a
  ``cp.async`` ring of two stages, S's a_hi b_hi products in a sum apart
  from the others, the lo parts left for the tensor cores to truncate;
* ``key_tile_32`` — KV tiles of 32 rows;
* ``three_stages`` — a ring of three stages of 32-row tiles (three of 64
  rows do not fit beside the q tile);
* ``four_warps`` — 4 warps of 16 q rows and 32-row KV tiles: two blocks an
  SM (64-row KV tiles would leave room for one);
* ``q_in_regs`` — Q's raw fragments kept in registers for the whole walk;
* ``lo_rounded`` — the lo parts rounded to TF32 too (two more integer
  operations a value, as ``ssd_scan`` splits);
* ``s_one_sum`` — all three passes of S into one sum;
* ``single_tf32`` — one TF32 pass (a_hi b_hi) per product in place of the
  split's three, the witness that the split is needed;
* ``baseline`` (with ``--baseline ROOT``) — the float32 kernel of another
  checkout at ``ROOT``, e.g. the parent commit's unpacked tree (its
  ``flash_attention_f32`` entry: the float32 SIMT kernel this route replaced).

Each variant edits the source with ``tf32_split.cuh`` inlined.  For each
it prints the registers and spill bytes of its kernels at d = 112 and 128
(``ptxas -v``) and, per shape, the error against the plain twin — bf16: the
worst ``|got - want| / (8e-3 |want| + 1e-3)`` (``chip_smoke.py`` phase 3's
bound is 1); float32: the largest ``|got - want|`` (its bound is 2e-5) — and
the device time of one call (CUDA events around each call, the calls queued
behind a sleep so host launch time is not counted; median of 15 calls in
each of two rounds, variants in turns; L2 flushed, then warm), beside
``scaled_dot_product_attention`` in the same dtype (``library``).  Shapes:
zamba2-7b's (2, 32, 32, 2048, 112) and qwen3-1.7b's (1, 16, 8, 2048, 128)
causal, and a ragged (2, 4, 2, 200, 112).  Needs ``nvcc`` and a card::

    PYTHONPATH=src python -m repro_torch.benchmarks.flash_variants [--baseline ROOT]
"""
from __future__ import annotations

import argparse
import re
import subprocess
from pathlib import Path

import torch
from torch.nn.functional import scaled_dot_product_attention as sdpa

from ..kernels._build import BUILD_DIR, CSRC_DIR, CudaKernel, build_all, pointer, stream_handle
from ..kernels.flash_attention.flash_attention import _ARGS, _ENTRY
from ..kernels.flash_attention.ref import attention_ref

__all__ = ["VARIANTS", "SHAPES", "run"]

_P_LO_PASS = "for (int kk = 0; kk < kWgBlockK / 16; ++kk)\n        wgmma_rs(acc_o, p_lo[kk],"
_PARTS = "for (int part = 0; part < 3; ++part)"
_KEY_TILE_32 = ("constexpr int kTfBlockK = 64;", "constexpr int kTfBlockK = 32;")
# Edits of csrc/flash_attention.cu by route, one design choice each.
VARIANTS = {
    "wgmma": {
        "committed": [],
        "p_single_bf16": [(_P_LO_PASS, _P_LO_PASS.replace("kk < kWgBlockK / 16", "kk < 0"))],
        "mask_every_tile": [("if (t == n_tiles - 1) {", "if (true) {"),
                            (" = exp2_ftz(", " = exp2f(")],
        "three_stages": [("constexpr int kWgStages = 2;", "constexpr int kWgStages = 3;")],
    },
    "mma_tf32": {
        "committed": [],
        "key_tile_32": [_KEY_TILE_32],
        "three_stages": [_KEY_TILE_32,
                         ("constexpr int kTfStages = 2;", "constexpr int kTfStages = 3;")],
        "four_warps": [_KEY_TILE_32, ("constexpr int kTfWarps = 8;", "constexpr int kTfWarps = 4;")],
        "q_in_regs": [("constexpr bool kTfQInRegs = false;", "constexpr bool kTfQInRegs = true;")],
        "lo_rounded": [("  lo = __float_as_uint(v - __uint_as_float(hi));",
                        "  lo = round_tf32(v - __uint_as_float(hi));")],
        "s_one_sum": [("mma_part(sb[j], ss[j], fa, fb[j], part);",
                       "mma_part(sb[j], sb[j], fa, fb[j], part);")],
        "single_tf32": [(_PARTS, "for (int part = 2; part < 3; ++part)")],
    },
}
_DTYPE = {"wgmma": torch.bfloat16, "mma_tf32": torch.float32}
SHAPES = ((2, 32, 32, 2048, 112, True), (1, 16, 8, 2048, 128, True),
          (2, 4, 2, 200, 112, True))
_BASELINE_ENTRY = "flash_attention_f32"


def edited_source(route: str, variant: str) -> str:
    """The committed source, ``tf32_split.cuh`` inlined, with ``variant``'s
    edits of ``route`` applied."""
    header = '#include "tf32_split.cuh"'
    text = (CSRC_DIR / "flash_attention.cu").read_text()
    text = text.replace(header, (CSRC_DIR / "tf32_split.cuh").read_text())
    for old, new in VARIANTS[route][variant]:
        if old not in text:
            raise ValueError(f"variant {route}/{variant}: {old!r} is not in the source")
        text = text.replace(old, new)
    return text


def _ptxas(kernel) -> str:
    """Registers and spill-store bytes of the kernel's float32 instantiations
    at d = 112 and 128, from its ptxas -v log."""
    out, dp = [], None
    for line in kernel.build_log.splitlines():
        if "Compiling entry function" in line:
            m = re.search(r"tf32ILi(\d+)E", line)
            dp = m.group(1) if m and m.group(1) in ("112", "128") else None
        elif dp and "spill stores" in line:
            spill = re.search(r"(\d+) bytes spill stores", line).group(1)
            out.append(f"d{dp} spill {spill} B")
        elif dp and "registers" in line:
            regs = re.search(r"Used (\d+) registers", line).group(1)
            out.append(f"d{dp} {regs} regs")
    return "; ".join(out)


def _kernels(baseline):
    """{route: {variant: (CudaKernel, entry)}}, each source written under the
    build dir."""
    (BUILD_DIR / "variants").mkdir(parents=True, exist_ok=True)
    kernels = {}
    for route, variants in VARIANTS.items():
        entry = _ENTRY[route][_DTYPE[route]]
        kernels[route] = {}
        for name in variants:
            path = BUILD_DIR / "variants" / f"flash_attention_{route}_{name}.cu"
            path.write_text(edited_source(route, name))
            kernels[route][name] = (CudaKernel(f"flash_{route}_{name}", path, {entry: _ARGS}),
                                    entry)
    if baseline is not None:
        path = Path(baseline).resolve() / "src" / "repro_torch" / "csrc" / "flash_attention.cu"
        kernels["mma_tf32"]["baseline"] = (
            CudaKernel("flash_baseline", path, {_BASELINE_ENTRY: _ARGS}), _BASELINE_ENTRY)
    return kernels


def _call(kernel, entry, q, k, v, causal):
    b, hq, sq, d = q.shape
    out = torch.empty_like(q)
    kernel.launch(entry, pointer(q), pointer(k), pointer(v), pointer(out), b, hq,
                  k.shape[1], sq, k.shape[2], d, d ** -0.5, int(causal), stream_handle(q))
    return out


def _times_us(fn, flush_buf, flush: bool, reps: int = 15):
    """Device time of each of ``reps`` calls, enqueued behind a 5 ms sleep so
    the host's launch cost stays off the clock."""
    events = []
    torch.cuda._sleep(10_000_000)
    for _ in range(reps):
        if flush:
            flush_buf.zero_()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return [s.elapsed_time(e) * 1e3 for s, e in events]


def _error(route, got, want) -> float:
    """bf16: the worst |got - want| / (8e-3 |want| + 1e-3) (bound 1);
    float32: the largest |got - want| (bound 2e-5)."""
    diff = (got.float() - want).abs()
    if route == "wgmma":
        return (diff / (8e-3 * want.abs() + 1e-3)).max().item()
    return diff.max().item()


def run(baseline=None) -> None:
    if not torch.cuda.is_available():
        raise SystemExit("flash_variants times the CUDA kernel: no card here")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True)
    print(f"card: {card.stdout.strip()}", flush=True)
    kernels = _kernels(baseline)
    libs = [kern for by_name in kernels.values() for kern, _ in by_name.values()]
    print(f"built {len(libs)} variants in {build_all(libs):.2f} s", flush=True)
    for name, (kern, _) in kernels["mma_tf32"].items():
        print(f"ptxas,mma_tf32,{name},{_ptxas(kern)}", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(15)
    flush_buf = torch.empty(64 * 2**20, device="cuda")
    print("route,variant,shape,error,flushed_us,warm_us", flush=True)
    for route, by_name in kernels.items():
        dtype = _DTYPE[route]
        for b, hq, hkv, s, d, causal in SHAPES:
            q = torch.randn(b, hq, s, d, generator=gen, device="cuda").to(dtype)
            k, v = (torch.randn(b, hkv, s, d, generator=gen, device="cuda").to(dtype)
                    for _ in range(2))
            want = attention_ref(q, k, v, causal=causal).float()
            calls = {name: (lambda kern=kern, entry=entry: _call(kern, entry, q, k, v, causal))
                     for name, (kern, entry) in by_name.items()}
            calls["library"] = lambda: sdpa(q, k, v, is_causal=causal, enable_gqa=True)
            times = {name: {True: [], False: []} for name in calls}
            for name in list(calls) + list(calls)[::-1]:
                for flush in (True, False):
                    calls[name]()
                    times[name][flush] += _times_us(calls[name], flush_buf, flush)
            for name, fn in calls.items():
                err = _error(route, fn(), want)
                med = {f: sorted(t)[len(t) // 2] for f, t in times[name].items()}
                print(f"{route},{name},{(b, hq, hkv, s, d)},{err:.3e},{med[True]:.2f},"
                      f"{med[False]:.2f}", flush=True)
            del q, k, v, want


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--baseline", help="root of another checkout whose float32 "
                        "flash_attention kernel is timed beside these")
    run(parser.parse_args().baseline)
