#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

Run from the root of a checkout, with no arguments::

    python3 chip_smoke.py

It drives the port's paths through the eleven hand-written CUDA kernels — an
``SDESampleEngine`` serving EES(2,5) and EES(2,7) Monte-Carlo sampling
requests of the neural Langevin SDE at its Table-1 widths (``d_obs=1,
d_z=16, width=32``) plus an ODE-mode ``sdeint``, the paper's Table-1
training run with the reversible adjoint, the serving and training of
additive- and general-noise SDEs, and the LM substrate's prefill and decode
of zamba2-7b at full width — and checks what comes out:

1. the card (``nvidia-smi`` name and power limit); TF32 off, bf16 GEMMs
   reducing in float32;
2. the kernel builds (one ``nvcc`` per source, in parallel);
3. each kernel against its plain PyTorch twin on the card, float32 and
   float64, at the served (or trained) shape, a ragged size and an
   unaligned view (the general-noise kernels at (N, d, m) = (65536, 16, 4)
   and (1001, 5, 3) on their row route, (65536, 16, 128) on their staged
   route, each case's route checked, ``torch.baddbmm`` and ``torch.einsum``
   timed beside them at both timed widths); flash attention in float32 and bf16
   at the reference's test shapes, zamba2-7b's (2, 32, 32, 2048, 112),
   qwen3-1.7b's (1, 16, 8, 2048, 128), a ragged 200 and the 128-row tile's
   edges, each case on the route it must take (float32 on the mma_tf32
   route, bf16 with d % 8 == 0 on the wgmma route, other bf16 on the SIMT
   route) and the tensor-core routes' instructions counted in the built
   library's SASS (float32 timed at both LM shapes beside SDPA in float32,
   whose kernel is named from the profiler), and the SSD scan at
   the reference's test shapes, its decay extremes, zamba2-7b's and
   mamba2-130m's layer at 2048 tokens, its TF32 ``mma.sync`` instructions
   counted in its library's SASS; with each kernel's time, the twin's
   time, its bound and, where one PyTorch call computes it, that call's time
   (L2 flushed and warm); ``axpy_chain`` at every chain length it has a
   kernel for (1..8) and at 9 and 17 (split into launches), bitwise;
   ``increment_pre`` and ``axpy_chain`` also timed at the Table-1 batch
   (4,096 elements) and at 16,777,216, and their wrappers' host us per call
   beside ``torch.add``'s at 4,096;
4. serving requests A-D (A and B share a padded bucket; D is A's seed on the
   plain path), with shapes, finiteness, A against D, A against a CPU run of
   the plain path, paths/s, dispatch counts and a profile of one dispatch;
5. an ODE-mode ``sdeint`` through the ``williamson2n`` kernel against the
   plain path;
6. the serving path's launch counts;
7. Table 1 on the card: the four ``:use_kernels=True`` solvers trained for
   the reference's 60 epochs at 256 paths, after their first epochs are
   held against the plain path on the card and on the CPU; the
   ``axpy_chain`` launches by chain length; one step of each under
   ``torch.cuda.set_sync_debug_mode("error")``;
8. one EES(2,5) training step at 65,536 paths under the reversible and the
   full adjoint, 8 and 64 steps: peak device memory, and the profile of one
   reversible step;
9. the step-kernel benchmark's additive, general and diagonal terms
   (``repro_torch.benchmarks.step_kernels``, width 16, 4 channels, 64 steps)
   served through ``SDESampleEngine`` — requests E-N: the prediffused
   additive route (E bitwise equal to its diagonal relabel G), general noise
   through the kernels (J against the plain L), Reversible Heun on both, and
   the ``"auto"`` specs resolving to SRA1, EES(2,7), EES(2,5) and Milstein —
   with a CPU cross-check, paths/s and one tick's device time; then one
   general-noise request at the reference kernel's width m = 128 (65,536
   paths, d = 16), ``ees25:use_kernels=True`` against plain ``ees25`` on the
   same seed (1e-5), with the device ms of one tick of each;
10. three training steps on those terms: the additive term under the full
   adjoint through the prediffused kernels (bitwise equal to the diagonal
   relabel on the plain route) and the general term under the reversible
   adjoint through EES(2,5) and Reversible Heun (1e-5 of the plain route);
   one step of each under ``set_sync_debug_mode("error")``;
11. the LM prefill of zamba2-7b at full width: in float32 at 12 layers
   (B=2, S=256) the kernel path (2 ``flash_attention`` launches, both on the
   mma_tf32 route) against the plain path, ``forward`` against
   token-by-token ``serve_step``, and the card against a CPU run of the
   plain path (6 layers, B=1, S=128), each within 1e-4 of max|logit|; the
   same 12 layers with bf16 weights, the kernel path (the wgmma route)
   within twice the bf16 plain path's distance from the float32 plain path
   plus 1e-3 of max|logit|; then in bf16 at all 81 layers
   (``init_params(PRNGKey(0))``) one ``head_positions="last"`` prefill of
   B=2 x 2048 tokens: launch counts (14 ``flash_attention``, all on the
   wgmma route, 81 ``ssd_scan``), peak memory, tokens/s, the profile by
   kernel kind, and no host sync;
12. the decode ``Engine`` on those weights: 8 requests of 8-token prompts,
   greedy, ``slots=8, max_len=64``: tokens/s, ticks, finite logits, and the
   same tokens from a second drain on a new engine; one decode step's host
   wall, device time and launches.

The launch counts are zeroed just before each path (phases 4-5, the
60-epoch runs of phase 7, phase 9's drain and its m = 128 request, phase
10's runs and phase 11's counted prefill) and read just after; a kernel of
the path with no launch there fails the run.  The second-to-last line is the
``{"kernels": [...]}`` record (the general-noise kernels with their
``launches_by_route``) and the last line ``{"ok": true, "device":
{...}}``.  Any failed phase exits non-zero; with no
CUDA device, or without the ``src/repro_torch`` package beside this script,
it exits non-zero before printing any result.  It imports nothing of jax or
of the jax package ``repro``.
"""
from __future__ import annotations

import copy
import json
import os
import re
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(REPO, "src")

HBM_BYTES_PER_S = 3.35e12     # H100 SXM HBM3 (NVIDIA data sheet)
FP32_FLOPS = 67e12            # H100 SXM float32 outside the tensor cores
BF16_FLOPS = 989e12           # H100 SXM bf16 tensor cores, dense
TF32_FLOPS = 495e12           # H100 SXM TF32 tensor cores, dense
SERVE_SLOTS = 65536
D_OBS, D_Z, WIDTH = 1, 16, 32  # benchmarks/table1_ou.py widths
RAGGED = 1_000_003
TRAIN_ELEMS = 256 * D_Z        # one Table-1 training batch (benchmarks/table1_ou.py)
LARGE_ELEMS = 1 << 24          # three 64 MiB float32 streams, past the 50 MB L2
# axpy_chain's chain lengths held bitwise: each one a kernel is built for
# (1..8), and two the wrapper splits into consecutive launches.
CHAIN_LENGTHS = tuple(range(1, 9)) + (9, 17)
CHAIN_COEFFS = tuple((-1) ** k * (k + 1) / 7 for k in range(CHAIN_LENGTHS[-1]))
CHECK_EPOCHS = 3              # Table-1 epochs held against the plain path
# General-noise kernel shapes (rows, d, m): the served state with the
# reference benchmark's 4 channels, the TPU kernel's lane-aligned m = 128,
# and a ragged shape no (8, 128) tile fits.
GENERAL_SHAPES = ((SERVE_SLOTS, D_Z, 4), (SERVE_SLOTS, D_Z, 128), (1001, 5, 3))


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    raise SystemExit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def card_line() -> str:
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if proc.returncode != 0:
        fail(f"nvidia-smi failed: {proc.stderr.strip()}")
    return proc.stdout.strip().splitlines()[0]


class Timer:
    """Device time of a callable's kernels, from the profiler's CUDA trace
    (host launch gaps excluded), with the L2 cache flushed before each call
    (cold) or not (warm, back-to-back).  Falls back to CUDA events around
    each call if the profiler records no device time."""

    def __init__(self, torch):
        self.torch = torch
        self.flush_buf = torch.empty(256 * 1024 * 1024 // 4, dtype=torch.float32,
                                     device="cuda")

    def kernels_us(self, fn, reps: int = 30, flush: bool = True):
        """{kernel name: (total device us, launches)} over ``reps`` calls."""
        torch = self.torch
        from torch.profiler import ProfilerActivity, profile

        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                if flush:
                    self.flush_buf.zero_()
                fn()
            torch.cuda.synchronize()
        totals = {}
        for ev in prof.events():
            if ev.device_type != torch.autograd.DeviceType.CUDA:
                continue
            if flush and ("FillFunctor" in ev.name
                          or ev.name.startswith("Memset")):
                continue  # the L2 flush
            us, n = totals.get(ev.name, (0.0, 0))
            totals[ev.name] = (us + ev.time_range.elapsed_us(), n + 1)
        return totals

    def ms(self, fn, match=None, reps: int = 30, flush: bool = True) -> float:
        """Mean device ms per call of the kernels whose name contains
        ``match`` (all kernels when None)."""
        totals = self.kernels_us(fn, reps, flush)
        us = sum(t for name, (t, _) in totals.items()
                 if match is None or match in name)
        if us > 0:
            return us / reps / 1e3
        print("  (profiler recorded no device time; timing with CUDA events)",
              flush=True)
        return self.event_ms(fn, reps, flush)

    def event_ms(self, fn, reps: int, flush: bool) -> float:
        torch = self.torch
        events = []
        for _ in range(reps):
            if flush:
                self.flush_buf.zero_()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            events.append((start, end))
        torch.cuda.synchronize()
        return sum(s.elapsed_time(e) for s, e in events) / reps


def compare(torch, got, want):
    """(max abs err, max rel err, bitwise?) over matching output tuples."""
    abs_err, rel_err, same = 0.0, 0.0, True
    for g, w in zip(got, want):
        d = (g - w).abs()
        abs_err = max(abs_err, d.max().item())
        rel_err = max(rel_err, (d / w.abs().clamp_min(1e-30)).max().item())
        same = same and torch.equal(g, w)
    return abs_err, rel_err, same


def _flat_inputs(torch, gen, n_in, n, offset=0):
    """``n_in`` float vectors of ``n`` elements (an offset view when
    ``offset``), drawn on the card."""
    def make(dtype):
        return [torch.randn(n + offset, generator=gen, device="cuda",
                            dtype=dtype)[offset:] for _ in range(n_in)]
    return make


def _row_inputs(torch, gen, n_state, rows, d, m):
    """General-noise operands: ``n_state`` states ``(rows, d)``, then the
    diffusion ``(rows, d, m)`` and the increment ``(rows, m)``."""
    def make(dtype):
        draw = lambda *shape: torch.randn(*shape, generator=gen, device="cuda",  # noqa: E731
                                          dtype=dtype)
        return ([draw(rows, d) for _ in range(n_state)]
                + [draw(rows, d, m), draw(rows, m)])
    return make


def _timed_row(name, label, timer, kernel, plain, library, symbol, bytes_moved,
               ops, peak, peak_name, max_abs_err):
    """Times a kernel (L2 flushed and warm), its twin and the library call;
    returns the record's numbers."""
    ms = timer.ms(kernel, symbol)
    ms_warm = timer.ms(kernel, symbol, flush=False)
    plain_ms = timer.ms(plain)
    library_ms = None if library is None else timer.ms(library[1])
    bytes_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / peak * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    lib = "no single PyTorch call"
    if library is not None:
        library_warm = timer.ms(library[1], flush=False)
        lib = (f"{library[0]} {library_ms * 1e3:.2f} us ({library_warm * 1e3:.2f} us "
               f"warm)")
    print(f"  {name} {label}, device time: kernel {ms * 1e3:.2f} us with L2 "
          f"flushed ({ms_warm * 1e3:.2f} us warm), plain twin {plain_ms * 1e3:.2f}"
          f" us, {lib}; bound {bound_ms * 1e3:.2f} us ({bytes_moved} B at 3.35 "
          f"TB/s: {bytes_ms * 1e3:.2f} us; {ops:.4g} flop at the {peak_name} "
          f"rate: {ops_ms * 1e3:.2f} us); {bound_ms / ms:.1%} of the bound",
          flush=True)
    return dict(max_abs_err=max_abs_err, ms=ms, ms_warm=ms_warm, plain_ms=plain_ms,
                bound_ms=bound_ms, library_ms=library_ms,
                bound_by="bytes" if bytes_ms >= ops_ms else "operations")


def kernel_phase(torch, timer):
    """Phase 3: each kernel against its plain twin; returns per-kernel stats.

    Every kernel is held at each of its shapes in float32 and float64 and
    timed in float32 at its main-path shape (the first of ``timed``; the
    general-noise kernels also at m = 128), with the L2 cache flushed and
    warm, beside its plain twin, its bound and, where one PyTorch call
    computes the same function, that call (timed here, used nowhere in the
    port)."""
    from repro_torch.benchmarks.stream_variants import host_us_per_call
    from repro_torch.core.williamson import EES25_2N
    from repro_torch.kernels.sde_step import ref as sref
    from repro_torch.kernels.sde_step.sde_step import (AXPY_CHAIN, INCREMENT_GENERAL,
                                                       MAX_INCS, WS_STAGE_GENERAL,
                                                       axpy_chain, general_route,
                                                       increment_diag,
                                                       increment_general, increment_pre,
                                                       route_launches, ws_stage_diag,
                                                       ws_stage_diag_bwd,
                                                       ws_stage_general, ws_stage_pre)
    from repro_torch.kernels.williamson2n.ref import williamson2n_ref
    from repro_torch.kernels.williamson2n.williamson2n import williamson2n

    a, b, h = EES25_2N.A[1], EES25_2N.B[1], 0.25
    gen = torch.Generator(device="cuda").manual_seed(1234)
    served = SERVE_SLOTS * D_Z

    def flat(n_in, train=False):
        """The flat shapes: (the Table-1 batch,) served, ragged, unaligned;
        and the timed served shape with its float32 bytes per element."""
        shapes = [(f"served n={served}", _flat_inputs(torch, gen, n_in, served)),
                  (f"ragged n={RAGGED}", _flat_inputs(torch, gen, n_in, RAGGED)),
                  (f"unaligned n={RAGGED}",
                   _flat_inputs(torch, gen, n_in, RAGGED, 1))]
        if train:
            shapes.insert(0, (f"training n={TRAIN_ELEMS}",
                              _flat_inputs(torch, gen, n_in, TRAIN_ELEMS)))
        return shapes

    def timed_flat(n_in, streams, ops, sizes=(served,)):
        """The timed float32 shapes, the served one first (the record's):
        inputs, bytes moved and flops."""
        labels = {served: "served", TRAIN_ELEMS: "training", LARGE_ELEMS: "large"}
        return [(f"{labels[n]} n={n}", _flat_inputs(torch, gen, n_in, n),
                 streams * n * 4, ops * n) for n in sizes]

    stream_sizes = (served, TRAIN_ELEMS, LARGE_ELEMS)

    def general(n_state, n_out, update_ops):
        """Shapes of a general-noise kernel: (65536, 16, 4), (65536, 16, 128)
        and a ragged (1001, 5, 3); the timed (N, d, m) with their float32
        bytes (each input read once, each output written once) and flops
        (``2m + 1`` per output for ``f*h + g@dW``, plus ``update_ops`` for
        the 2N update)."""
        shapes = [(f"(N,d,m)=({n},{d},{m})",
                   _row_inputs(torch, gen, n_state, n, d, m))
                  for n, d, m in GENERAL_SHAPES]
        timed = []
        for n, d, m in GENERAL_SHAPES[:2]:
            elems = n * d * m + n * m + (n_state + n_out) * n * d
            flops = n * d * (2 * m + 1 + update_ops)
            timed.append((f"(N,d,m)=({n},{d},{m})",
                          _row_inputs(torch, gen, n_state, n, d, m),
                          elems * 4, flops))
        return shapes, timed

    gen_inc, gen_inc_timed = general(1, 1, 0)
    gen_ws, gen_ws_timed = general(3, 2, 4)
    specs = {
        "ws_stage_diag": dict(
            symbol="ws_stage_diag_kernel", shapes=flat(5), exact=False,
            timed=timed_flat(5, 7, 6),
            kernel=lambda x: ws_stage_diag(*x, h, a=a, b=b),
            plain=lambda x: sref.ws_stage_diag_ref(*x, h, a, b), library=None),
        "williamson2n": dict(
            symbol="williamson2n_kernel", shapes=flat(3), exact=False,
            timed=timed_flat(3, 5, 4),
            kernel=lambda x: williamson2n(*x, a=a, b=b),
            plain=lambda x: williamson2n_ref(*x, a, b), library=None),
        "ws_stage_diag_bwd": dict(
            symbol="ws_stage_diag_bwd_kernel", shapes=flat(4, train=True),
            exact=True, timed=timed_flat(4, 8, 6),
            kernel=lambda x: ws_stage_diag_bwd(*x, h, a=a, b=b),
            plain=lambda x: sref.ws_stage_diag_bwd_ref(*x, h, a, b),
            library=None),
        "increment_diag": dict(
            symbol="increment_diag_kernel", shapes=flat(3, train=True),
            exact=True, timed=timed_flat(3, 4, 3),
            kernel=lambda x: (increment_diag(*x, h),),
            plain=lambda x: (sref.increment_diag_ref(*x, h),), library=None),
        "axpy_chain": dict(
            symbol="axpy_chain_kernel", shapes=flat(2, train=True), exact=True,
            timed=timed_flat(2, 3, 2, stream_sizes),
            kernel=lambda x: (axpy_chain(x[0], x[1:], [0.5]),),
            plain=lambda x: (sref.axpy_chain_ref(x[0], x[1:], [0.5]),),
            library=("torch.add(y, inc, alpha=c)",
                     lambda x: torch.add(x[0], x[1], alpha=0.5))),
        "increment_pre": dict(
            symbol="increment_pre_kernel", shapes=flat(2), exact=True,
            timed=timed_flat(2, 3, 2, stream_sizes),
            kernel=lambda x: (increment_pre(*x, h),),
            plain=lambda x: (sref.increment_pre_ref(*x, h),),
            library=("torch.add(w, f, alpha=h)",
                     lambda x: torch.add(x[1], x[0], alpha=h))),
        "ws_stage_pre": dict(
            symbol="ws_stage_pre_kernel", shapes=flat(4), exact=True,
            timed=timed_flat(4, 6, 5),
            kernel=lambda x: ws_stage_pre(*x, h, a=a, b=b),
            plain=lambda x: sref.ws_stage_pre_ref(*x, h, a, b), library=None),
        "increment_general": dict(
            symbol="increment_general_kernel", shapes=gen_inc, exact=True,
            timed=gen_inc_timed,
            kernel=lambda x: (increment_general(*x, h),),
            plain=lambda x: (sref.increment_general_ref(*x, h),),
            library=("torch.baddbmm(f[..., None], g, dW[..., None], beta=h)",
                     lambda x: torch.baddbmm(x[0][..., None], x[1],
                                             x[2][..., None], beta=h)),
            routed=INCREMENT_GENERAL,
            yardsticks=[("torch.einsum('...dm,...m->...d', g, dW) (the plain route's "
                         "product alone)",
                         lambda x: torch.einsum("...dm,...m->...d", x[1], x[2]))]),
        "ws_stage_general": dict(
            symbol="ws_stage_general_kernel", shapes=gen_ws, exact=True,
            timed=gen_ws_timed,
            kernel=lambda x: ws_stage_general(*x, h, a=a, b=b),
            plain=lambda x: sref.ws_stage_general_ref(*x, h, a, b),
            library=None, routed=WS_STAGE_GENERAL,
            yardsticks=[("torch.baddbmm(f[..., None], g, dW[..., None], beta=h) (the "
                         "yardstick of its product part only: no single call makes "
                         "both outputs)",
                         lambda x: torch.baddbmm(x[2][..., None], x[3],
                                                 x[4][..., None], beta=h))]),
    }
    stats = {}
    for name, spec in specs.items():
        worst = {}
        for dtype in (torch.float32, torch.float64):
            tol = 0.0 if spec["exact"] else 4 * torch.finfo(dtype).eps
            for label, make in spec["shapes"]:
                xs = make(dtype)
                routed = spec.get("routed")
                if routed is not None:
                    before = route_launches(routed)
                got = spec["kernel"](xs)
                want = spec["plain"](xs)
                torch.cuda.synchronize()
                abs_err, rel_err, same = compare(torch, got, want)
                scale = max(1.0, max(w.abs().max().item() for w in want))
                took = ""
                if routed is not None:
                    # the diffusion and increment are the last two operands
                    g, dW = xs[-2:]
                    expected = general_route(g.shape[-1], dtype, g.data_ptr() % 16 == 0
                                             and dW.data_ptr() % 16 == 0)
                    after = route_launches(routed)
                    taken = [r for r in after if after[r] != before[r]]
                    check(taken == [expected], f"{name} {dtype} {label} took the routes "
                          f"{taken}, not {expected}")
                    took = f", {expected} route"
                print(f"  {name} {str(dtype)[6:]} {label}{took}: max_abs_err="
                      f"{abs_err:.3e} max_rel_err={rel_err:.3e} bitwise={same}"
                      f" (tolerance {tol:.1e} x max|out|)", flush=True)
                check(abs_err <= tol * scale,
                      f"{name} {dtype} {label} disagrees with its plain twin")
                worst[(dtype, label)] = abs_err
                del xs, got, want
        rows = []
        for label, make, bytes_moved, ops in spec["timed"]:
            xs = make(torch.float32)
            library = spec["library"]
            if spec.get("routed") is not None:
                label += f", {general_route(xs[-2].shape[-1], torch.float32, True)} route"
            rows.append(_timed_row(
                name, f"float32 {label}", timer, lambda: spec["kernel"](xs),
                lambda: spec["plain"](xs),
                None if library is None else (library[0], lambda: library[1](xs)),
                spec["symbol"], bytes_moved, ops, FP32_FLOPS, "float32",
                max(worst.values())))
            for what, fn in spec.get("yardsticks", ()):
                flushed = timer.ms(lambda: fn(xs))
                warm = timer.ms(lambda: fn(xs), flush=False)
                print(f"  {name} float32 {label}: {what} {flushed * 1e3:.2f} us with L2 "
                      f"flushed ({warm * 1e3:.2f} us warm)", flush=True)
            del xs
        stats[name] = rows[0]

    # axpy_chain at every chain length it has a kernel for and at two the
    # wrapper splits into launches of at most MAX_INCS increments, bitwise.
    for dtype in (torch.float32, torch.float64):
        for label, make in flat(CHAIN_LENGTHS[-1] + 1, train=True):
            xs = make(dtype)
            launched = []
            for s in CHAIN_LENGTHS:
                before = AXPY_CHAIN.launches
                got = axpy_chain(xs[0], xs[1:s + 1], CHAIN_COEFFS[:s])
                launched.append(AXPY_CHAIN.launches - before)
                want = sref.axpy_chain_ref(xs[0], xs[1:s + 1], CHAIN_COEFFS[:s])
                check(torch.equal(got, want) and launched[-1] == -(-s // MAX_INCS),
                      f"axpy_chain {dtype} {label} s={s} disagrees with its plain "
                      f"twin or took {launched[-1]} launches")
            print(f"  axpy_chain {str(dtype)[6:]} {label}: bitwise equal to the twin "
                  f"at s = {', '.join(map(str, CHAIN_LENGTHS))} (launches "
                  f"{launched})", flush=True)
            del xs

    # Host cost of a call at the Table-1 size, beside torch.add's.
    y, inc = _flat_inputs(torch, gen, 2, TRAIN_ELEMS)(torch.float32)
    host = {"axpy_chain": host_us_per_call(lambda: axpy_chain(y, [inc], [0.5])),
            "increment_pre": host_us_per_call(lambda: increment_pre(y, inc, h)),
            "torch.add": host_us_per_call(lambda: torch.add(y, inc, alpha=0.5))}
    print(f"  host us per call at n={TRAIN_ELEMS} (back to back, median of 5 "
          f"rounds of 2000): " + ", ".join(f"{k} {v:.2f}" for k, v in host.items()),
          flush=True)
    return stats


# Flash-attention shapes (b, hq, hkv, s, d, causal, sm_scale): the
# reference's kernel tests (tests/test_kernels.py: MQA, GQA group 4,
# bidirectional, sm_scale 0.5), then zamba2-7b's shared attention at 2048
# tokens (the timed main-path shape), qwen3-1.7b's GQA and a ragged length.
FLASH_REF_SHAPES = ((2, 4, 2, 256, 64, True, None), (1, 8, 1, 128, 128, True, None),
                    (2, 2, 2, 256, 64, False, None), (1, 4, 4, 384, 32, True, None),
                    (1, 16, 4, 256, 64, True, None), (1, 2, 2, 128, 64, True, 0.5))
FLASH_LM_SHAPES = ((2, 32, 32, 2048, 112, True, None), (1, 16, 8, 2048, 128, True, None),
                   (2, 4, 2, 200, 112, True, None), (2, 4, 2, 200, 112, False, None))
# The wgmma route's tile edges (one row, 127 and 129 against its 128-row
# tiles), GQA group 8, a bf16 head dim off TMA's 8-column rule (36, the
# SIMT route), and odd head dims whose float32 rows are not 16-byte
# multiples (the mma_tf32 route's 4-byte copies).
FLASH_EDGE_SHAPES = ((1, 8, 8, 1, 112, True, None), (2, 4, 1, 127, 112, True, None),
                     (1, 8, 1, 129, 128, False, None), (2, 4, 2, 200, 36, True, None),
                     (1, 4, 2, 130, 1, True, None), (2, 4, 2, 129, 127, False, None))
# SSD shapes (b, l, h, dh, ds, chunk): the reference's tests, then
# zamba2-7b's layer at 2048 tokens (timed) and mamba2-130m's.
SSD_REF_SHAPES = ((2, 128, 3, 16, 32, 32), (1, 256, 2, 64, 128, 128),
                  (2, 64, 4, 8, 16, 64), (1, 512, 1, 32, 64, 64))
SSD_LM_SHAPES = ((2, 2048, 112, 64, 64, 128), (1, 2048, 24, 64, 128, 128))


def _flash_inputs(torch, gen, shape, dtype):
    b, hq, hkv, s, d, _, _ = shape
    q = torch.randn(b, hq, s, d, generator=gen, device="cuda").to(dtype)
    k, v = (torch.randn(b, hkv, s, d, generator=gen, device="cuda").to(dtype)
            for _ in range(2))
    return q, k, v


def _ssd_inputs(torch, gen, shape):
    """The reference's test inputs: x, B, C normal; dt = softplus(normal) *
    0.1; A = -exp(normal)."""
    b, l, h, dh, ds, _ = shape
    draw = lambda *sh: torch.randn(*sh, generator=gen, device="cuda")  # noqa: E731
    return (draw(b, l, h, dh), torch.nn.functional.softplus(draw(b, l, h)) * 0.1,
            -torch.exp(draw(h)), draw(b, l, ds), draw(b, l, ds))


def sass_counts(kernel, ops):
    """Counts the instructions ``ops`` in a built kernel library's SASS
    (``cuobjdump -sass``); fails if any is 0 or cuobjdump is missing."""
    import shutil

    from repro_torch.kernels._build import _nvcc

    tool = os.path.join(os.path.dirname(_nvcc()), "cuobjdump")
    tool = tool if os.path.isfile(tool) else shutil.which("cuobjdump")
    check(tool is not None, "cuobjdump not found beside nvcc or on PATH")
    proc = subprocess.run([tool, "-sass", str(kernel.library_path())],
                          capture_output=True, text=True, timeout=300)
    check(proc.returncode == 0, f"cuobjdump -sass failed: {proc.stderr.strip()}")
    counts = {op: proc.stdout.count(op) for op in ops}
    print(f"  {kernel.name} library SASS (cuobjdump -sass): {counts}", flush=True)
    check(all(counts.values()), f"the {kernel.name} library lacks some of {ops}: "
          f"{counts}")
    return proc.stdout


def lm_kernel_phase(torch, timer):
    """Phase 3, the LM kernels: flash attention and the SSD scan against
    their plain twins (at the reference's kernel-vs-oracle tolerances) at
    the reference's test shapes and the LM path's, timed at the main-path
    shape; returns their stats."""
    from repro_torch.kernels import FLASH_ATTENTION, SSD_SCAN
    from repro_torch.kernels.flash_attention.flash_attention import (ROUTE_LAUNCHES,
                                                                     flash_attention, route)
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.kernels.ssd_scan.ref import ssd_chunked_ref, ssd_ref
    from repro_torch.kernels.ssd_scan.ssd_scan import ssd_scan
    from torch.nn.functional import scaled_dot_product_attention as sdpa

    gen = torch.Generator(device="cuda").manual_seed(4321)
    # the float32 runs at the 2048-token shapes draw from their own
    # generator, so every other case keeps its inputs
    gen_lm32 = torch.Generator(device="cuda").manual_seed(4322)
    stats, worst = {}, 0.0
    routes = dict.fromkeys(ROUTE_LAUNCHES, 0)
    for shape in FLASH_REF_SHAPES + FLASH_LM_SHAPES + FLASH_EDGE_SHAPES:
        causal, scale = shape[5], shape[6]
        dtypes = ((torch.float32, torch.bfloat16) if shape not in FLASH_LM_SHAPES[:2]
                  else (torch.bfloat16, torch.float32))
        for dtype in dtypes:
            own = dtype == torch.float32 and shape in FLASH_LM_SHAPES[:2]
            q, k, v = _flash_inputs(torch, gen_lm32 if own else gen, shape, dtype)
            before = dict(ROUTE_LAUNCHES)
            got = flash_attention(q, k, v, causal=causal, sm_scale=scale)
            took = [r for r in ROUTE_LAUNCHES if ROUTE_LAUNCHES[r] != before[r]]
            for r in took:
                routes[r] += ROUTE_LAUNCHES[r] - before[r]
            expected = ("mma_tf32" if dtype == torch.float32
                        else "wgmma" if shape[4] % 8 == 0 else "simt")
            check(took == [expected] and route(dtype, shape[4]) == expected,
                  f"flash_attention {shape} {dtype} took the routes {took}, not "
                  f"{expected}")
            want = attention_ref(q, k, v, causal=causal, sm_scale=scale)
            torch.cuda.synchronize()
            diff = (got.float() - want.float()).abs()
            err = diff.max().item()
            msg = (f"  flash_attention {str(dtype)[6:]} (b,hq,hkv,s,d)={shape[:5]} "
                   f"causal={causal} sm_scale={scale}, {expected} route: "
                   f"max_abs_err={err:.3e}")
            if dtype == torch.float32:  # the reference's kernel-vs-oracle atol
                ok = err <= 2e-5
                msg += " (tolerance 2e-5)"
            else:
                # both round a float32 result to bfloat16, so they may differ
                # by one bf16 ulp (<= 2^-7 of the value): held elementwise at
                # 8e-3 |want| + 1e-3, and at the reference's atol 3e-2
                ratio = (diff / (8e-3 * want.float().abs() + 1e-3)).max().item()
                ok = err <= 3e-2 and ratio <= 1.0
                msg += (f", worst |got-want| / (8e-3 |want| + 1e-3) = {ratio:.3f} "
                        f"(tolerance 1, and atol 3e-2)")
            print(msg, flush=True)
            check(got.dtype == dtype and got.shape == want.shape,
                  f"flash_attention {shape} {dtype}: output {got.dtype} {tuple(got.shape)}")
            check(ok, f"flash_attention {shape} {dtype} disagrees with its twin")
            worst = max(worst, err)
            del q, k, v, got, want, diff
    print(f"  flash_attention launches by route over these cases: {routes}; every "
          f"float32 case took the mma_tf32 route, every bf16 case with d % 8 == 0 "
          f"the wgmma route", flush=True)
    # wgmma, TMA loads, and the mma.sync TF32 products of the hi + lo split
    sass_counts(FLASH_ATTENTION, ("HGMMA", "UTMALDG", "HMMA.1688.F32.TF32"))
    rows = []
    # bf16 (the wgmma route) and float32 (the mma_tf32 route) at both LM
    # shapes.  The float32 products are float32-exact in three TF32
    # tensor-core passes, so their least time is at a third of the TF32 rate
    # (the float32 FMA rate's printed beside it).
    for shape, dtype in ((FLASH_LM_SHAPES[0], torch.bfloat16),
                         (FLASH_LM_SHAPES[1], torch.bfloat16),
                         (FLASH_LM_SHAPES[0], torch.float32),
                         (FLASH_LM_SHAPES[1], torch.float32)):
        b, hq, hkv, s, d, _, _ = shape
        q, k, v = _flash_inputs(torch, gen, shape, dtype)
        # causal: row t attends to t + 1 keys; QK^T and PV, 2 flops a MAC
        ops = 4 * b * hq * d * s * (s + 1) / 2
        bf16 = dtype == torch.bfloat16
        library = lambda: sdpa(q, k, v, is_causal=True, enable_gqa=True)  # noqa: E731
        rows.append(_timed_row(
            "flash_attention", f"{str(dtype)[6:]} {route(dtype, d)} route "
            f"(b,hq,hkv,s,d)={shape[:5]}", timer,
            lambda: flash_attention(q, k, v, causal=True),
            lambda: attention_ref(q, k, v, causal=True),
            ("scaled_dot_product_attention(is_causal=True, enable_gqa=True)", library),
            "flash_attention_kernel", q.element_size() * (2 * q.numel() + 2 * k.numel()),
            ops if bf16 else 3 * ops, BF16_FLOPS if bf16 else TF32_FLOPS,
            "bf16 tensor-core" if bf16 else "TF32 tensor-core (3 passes of the hi + lo "
            "split)", worst))
        if route(dtype, d) == "wgmma" and d < 128:
            print(f"  (the wgmma route pads d = {d} to 128 columns: {128 / d:.3f}x the "
                  f"bound's products, and splits P into two bf16 parts: P.V twice)",
                  flush=True)
        if not bf16:
            names = sorted(timer.kernels_us(library, reps=3, flush=False))
            print(f"  (the same work at the float32 FMA rate: {ops / FP32_FLOPS * 1e6:.2f}"
                  f" us; one TF32 pass, which would change the function: "
                  f"{ops / TF32_FLOPS * 1e6:.2f} us; SDPA's float32 kernels: {names})",
                  flush=True)
        del q, k, v
    stats["flash_attention"] = rows[0]

    worst = 0.0
    for shape in SSD_REF_SHAPES + SSD_LM_SHAPES + ("extremes",):
        if shape == "extremes":  # the reference's decay extremes (dt 5, A -8)
            x, _, _, B, C = _ssd_inputs(torch, gen, (1, 128, 2, 8, 16, 64))
            xs = (x, torch.full((1, 128, 2), 5.0, device="cuda"),
                  torch.tensor([-8.0, -0.001], device="cuda"), B, C)
            chunk, label = 64, "decay extremes (dt=5, A=(-8, -0.001))"
        else:
            xs, chunk = _ssd_inputs(torch, gen, shape), shape[5]
            label = f"(b,l,h,dh,ds,chunk)={shape}"
        got = ssd_scan(*xs, chunk=chunk)
        twin = ssd_chunked_ref(*xs, chunk=chunk)[0]
        torch.cuda.synchronize()
        check(bool(torch.isfinite(got).all()), f"ssd_scan {label}: non-finite y")
        scale = twin.abs().max().item()
        rel = (got - twin).abs().max().item() / scale
        msg = (f"  ssd_scan float32 {label}: vs chunked twin {rel:.3e} of "
               f"max|y|={scale:.3g} (tolerance 1e-5)")
        if shape in SSD_LM_SHAPES:
            check(rel <= 1e-5, f"ssd_scan {label} disagrees with its twin")
        else:  # the reference's tolerance against the sequential recurrence
            seq = ssd_ref(*xs)[0]
            err = (got - seq).abs().max().item()
            worst = max(worst, err)
            tol, ok = 5e-4, rel <= 1e-5
            if shape == "extremes":
                # 5e-4 is the reference's tolerance for its test arrays,
                # float64 there (its tests run with x64 on).  Here |y| reaches
                # hundreds and float32's own two plain forms part by more
                # than that: the kernel is held to the chunked twin at 5e-4
                # and to the recurrence at 5e-4 beyond that spread.
                spread = (twin - seq).abs().max().item()
                own = (seq.double() - ssd_ref(*(t.double() for t in xs))[0]
                       ).abs().max().item()
                near = (got - twin).abs().max().item()
                msg += (f"; float32 chunked twin vs float32 ssd_ref {spread:.3e} "
                        f"(must exceed 5e-4), float32 ssd_ref vs float64 ssd_ref "
                        f"{own:.3e}; kernel vs chunked twin {near:.3e} (tolerance "
                        f"5e-4)")
                check(spread > 5e-4, "the float32 twins of the decay extremes "
                      "agree to the reference's 5e-4: hold the kernel to it")
                tol = 5e-4 + spread
                ok = ok and near <= 5e-4
            msg += (f"; vs sequential ssd_ref max_abs_err={err:.3e} (tolerance "
                    f"{tol:.2e})")
            check(err <= tol and ok, f"ssd_scan {label} disagrees with its twins")
        print(msg, flush=True)
        del xs, got, twin
    b, l, h, dh, ds, L = SSD_LM_SHAPES[0]
    xs = _ssd_inputs(torch, gen, SSD_LM_SHAPES[0])
    nc, tri = l // L, L * (L + 1) // 2
    # MACs the chunked form needs: per (b, chunk, head) M@dx on the causal
    # triangle, C@S_in^T and the state update; C.B^T once per (b, chunk)
    # (the heads share B and C); 2 flops a MAC.
    ops = 2 * (b * nc * h * (tri * dh + 2 * L * dh * ds) + b * nc * tri * ds)
    bytes_moved = 4 * (2 * xs[0].numel() + xs[1].numel() + h + 2 * xs[3].numel())
    # the mma.sync TF32 products of the three launches, float32-exact by a
    # hi + lo split of both operands (three passes)
    variants = sorted(set(re.findall(r"HMMA\.[\w.]+", sass_counts(SSD_SCAN, ("HMMA",)))))
    print(f"  ssd_scan HMMA variants: {variants}", flush=True)
    check(any("TF32" in v for v in variants), "the ssd_scan library has no TF32 HMMA")
    # The kernel's products are float32-exact in three TF32 tensor-core
    # passes, so the least time for this work is at a third of the TF32
    # rate (below the float32 FMA rate's, printed beside it); its three
    # launches (state, pass, chunk) are timed together.
    stats["ssd_scan"] = _timed_row(
        "ssd_scan", f"float32 (b,l,h,dh,ds,chunk)={SSD_LM_SHAPES[0]}", timer,
        lambda: ssd_scan(*xs, chunk=L), lambda: ssd_chunked_ref(*xs, chunk=L),
        None, "ssd_scan_kernel", bytes_moved, 3 * ops, TF32_FLOPS,
        "TF32 tensor-core (3 passes of the hi + lo split)", worst)
    print(f"  (the same work at the float32 FMA rate: {ops / FP32_FLOPS * 1e6:.2f} us; "
          f"one TF32 pass, which would change the function: "
          f"{ops / TF32_FLOPS * 1e6:.2f} us)", flush=True)
    for name, fn in (("state", "ssd_scan_kernel_state"), ("pass", "ssd_scan_kernel_pass"),
                     ("chunk", "ssd_scan_kernel_chunk")):
        print(f"  ssd_scan launch {name}: {timer.ms(lambda: ssd_scan(*xs, chunk=L), fn) * 1e3:.2f}"
              f" us with L2 flushed", flush=True)
    return stats


def tick_breakdown(torch, timer, engine, keys, bucket):
    """Device time by kernel over one bucketed single-tick dispatch, the
    share of it spent realizing the threefry increments, and the device's
    busy share of the dispatch's host wall time."""
    from repro_torch.core.brownian import padded_brownian_path

    def dispatch():
        return engine.executor.dispatch(bucket, keys, (8,))

    totals = timer.kernels_us(dispatch, reps=3, flush=False)
    dev_ms = sum(t for t, _ in totals.values()) / 3 / 1e3
    launches = sum(n for _, n in totals.values()) // 3
    bm = padded_brownian_path(keys[0], 0.0, 0.25, 8, shape=(D_Z,))
    ts = torch.empty(9, device="cuda")
    rng_ms = timer.ms(lambda: bm.grid_increments(ts), reps=3, flush=False)
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        start = time.perf_counter()
        dispatch()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - start)
    wall_ms = min(walls) * 1e3
    print(f"  one bucketed tick ({SERVE_SLOTS} paths x 8 steps): host wall "
          f"{wall_ms:.3f} ms, device kernel time {dev_ms:.3f} ms over "
          f"{launches} launches (device busy {dev_ms / wall_ms:.0%}); bulk "
          f"threefry increments {rng_ms:.3f} ms of it", flush=True)
    rows = sorted(((t / 3, n // 3, name) for name, (t, n) in totals.items()),
                  reverse=True)
    for us, n, name in rows[:10]:
        print(f"    {us / 1e3:8.3f} ms {n:5d}x  {name[:100]}", flush=True)


def serve_phase(torch, timer):
    """Phase 4: requests A-D through the engine."""
    from repro_torch.core import PRNGKey, path_keys, sdeint
    from repro_torch.kernels import WS_STAGE_DIAG, WILLIAMSON2N
    from repro_torch.nsde import init_lsde, lsde_term
    from repro_torch.serving import BucketKey, SDESampleConfig, SDESampleEngine

    params = init_lsde(0, D_OBS, D_Z, WIDTH, device="cuda")
    term = lsde_term()
    with torch.no_grad():
        y0 = torch.zeros(D_Z, device="cuda") + params.encoder.b
        cfg = SDESampleConfig(slots=SERVE_SLOTS, ticks_per_dispatch=2)
        engine = SDESampleEngine(term, y0, cfg, args=params, device="cuda")

        # Warm-up (library load, cuBLAS handles, allocator) outside the count.
        engine.submit("ees25:use_kernels=True", t1=2.0, n_steps=8,
                      n_paths=1024, seed=99)
        engine.run()
        bucket = BucketKey("ees25:use_kernels=True", 0.0, 0.25, 8)
        tick_keys = path_keys(PRNGKey(7, device="cuda"), SERVE_SLOTS)[None]
        tick_breakdown(torch, timer, engine, tick_keys, bucket)

        # Dispatch and key packing must not wait on the device, or double
        # buffering cannot overlap planning with integration.
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            engine.executor.dispatch(bucket, tick_keys, (8,))
            path_keys(PRNGKey(123, device="cuda"), SERVE_SLOTS)
        except RuntimeError as exc:
            fail(f"dispatch synchronized with the host: {exc}")
        finally:
            torch.cuda.set_sync_debug_mode("default")
        print("  a bucketed dispatch and a request's key packing ran with "
              "torch.cuda.set_sync_debug_mode('error'): no host sync", flush=True)

        host = {"dispatch": 0.0, "deliver": 0.0}

        def timed(name, fn):
            def wrapper(*a, **k):
                start = time.perf_counter()
                try:
                    return fn(*a, **k)
                finally:
                    host[name] += time.perf_counter() - start
            return wrapper

        engine.executor.dispatch = timed("dispatch", engine.executor.dispatch)
        engine.scheduler.deliver = timed("deliver", engine.scheduler.deliver)
        engine.executor.n_dispatches = engine.executor.n_ticks = 0
        WS_STAGE_DIAG.launches = 0
        WILLIAMSON2N.launches = 0
        torch.cuda.synchronize()
        start = time.perf_counter()
        rid_a = engine.submit("ees25:use_kernels=True", t1=2.0, n_steps=8,
                              n_paths=2 * SERVE_SLOTS, seed=11)
        rid_b = engine.submit("ees25:use_kernels=True", t1=1.5, n_steps=6,
                              n_paths=SERVE_SLOTS, seed=12)
        rid_c = engine.submit("ees27:use_kernels=True", t1=2.0, n_steps=16,
                              save_every=4, n_paths=SERVE_SLOTS, seed=13)
        rid_d = engine.submit("ees25", t1=2.0, n_steps=8,
                              n_paths=2 * SERVE_SLOTS, seed=11)
        done = engine.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - start
    n_paths = 6 * SERVE_SLOTS
    print(f"  served 4 requests, {n_paths} paths in {wall:.3f} s: "
          f"{n_paths / wall:.0f} paths/s (host wall clock incl. delivery); "
          f"n_dispatches={engine.executor.n_dispatches} "
          f"n_ticks={engine.executor.n_ticks}; ws_stage_diag launches="
          f"{WS_STAGE_DIAG.launches}", flush=True)
    print(f"  host time in that run: {host['dispatch']:.3f} s enqueuing "
          f"dispatches, {host['deliver']:.3f} s scattering results to "
          f"requests, {wall - host['dispatch'] - host['deliver']:.3f} s "
          f"else (planning, key packing, waiting on the device, host copies)",
          flush=True)
    expect = {rid_a: (2 * SERVE_SLOTS, None), rid_b: (SERVE_SLOTS, None),
              rid_c: (SERVE_SLOTS, 4), rid_d: (2 * SERVE_SLOTS, None)}
    for rid, (n, saves) in expect.items():
        res = done[rid]
        check(res.y_final.shape == (n, D_Z), f"request {rid} y_final shape "
              f"{res.y_final.shape}")
        check(bool(torch.isfinite(torch.from_numpy(res.y_final)).all()),
              f"request {rid} has non-finite samples")
        check(not res.diverged.any() and res.retries == 0,
              f"request {rid} diverged")
        if saves is None:
            check(res.ys is None, f"request {rid} carries saves")
        else:
            check(res.ys.shape == (n, saves, D_Z), f"request {rid} ys shape")
            check(bool(torch.isfinite(torch.from_numpy(res.ys)).all()),
                  f"request {rid} has non-finite saves")
    check(done[rid_a].bucket == done[rid_b].bucket is not None,
          "A and B did not share a bucket")
    y_a = torch.from_numpy(done[rid_a].y_final)
    y_d = torch.from_numpy(done[rid_d].y_final)
    ad_err = (y_a - y_d).abs().max().item()
    ad_tol = 1e-5 * max(1.0, y_d.abs().max().item())
    print(f"  A (kernels) vs D (plain, same seed): max_abs_err={ad_err:.3e} "
          f"bitwise={torch.equal(y_a, y_d)} (tolerance {ad_tol:.1e})",
          flush=True)
    check(ad_err <= ad_tol, "A and D disagree")

    # A's first paths against the plain path on the CPU (torch CPU matmul
    # and erfinv, no kernel): float32 rounding-order differences only.
    n_ref = min(256, SERVE_SLOTS)
    cpu_params = copy.deepcopy(params).to("cpu")
    with torch.no_grad():
        ref = sdeint(term, "ees25", 0.0, 2.0, 8, y0.cpu(), args=cpu_params,
                     batch_keys=path_keys(PRNGKey(11, device="cpu"), n_ref),
                     device="cpu").y_final
    cpu_err = (y_a[:n_ref] - ref).abs().max().item()
    cpu_tol = 1e-4 * max(1.0, ref.abs().max().item())
    print(f"  A[:{n_ref}] vs the plain path on the CPU: max_abs_err="
          f"{cpu_err:.3e} (tolerance {cpu_tol:.1e})", flush=True)
    check(cpu_err <= cpu_tol, "served samples disagree with the CPU run")
    check(WS_STAGE_DIAG.launches > 0, "serving launched no ws_stage_diag kernel")
    return params, y0


def ode_phase(torch, params):
    """Phase 5: ODE-mode sdeint through the williamson2n kernel."""
    from repro_torch.core import PRNGKey, SDETerm, path_keys, sdeint
    from repro_torch.kernels import WILLIAMSON2N

    term = SDETerm(drift=lambda t, z, p: p.drift(z), noise="none")
    keys = path_keys(PRNGKey(5, device="cuda"), SERVE_SLOTS)
    y0 = torch.linspace(-1.0, 1.0, D_Z, device="cuda")
    before = WILLIAMSON2N.launches
    with torch.no_grad():
        fused = sdeint(term, "ees25:use_kernels=True", 0.0, 2.0, 8, y0,
                       args=params, batch_keys=keys, device="cuda").y_final
        plain = sdeint(term, "ees25", 0.0, 2.0, 8, y0, args=params,
                       batch_keys=keys, device="cuda").y_final
        torch.cuda.synchronize()
    launches = WILLIAMSON2N.launches - before
    err = (fused - plain).abs().max().item()
    tol = 1e-5 * max(1.0, plain.abs().max().item())
    print(f"  ODE sdeint ({SERVE_SLOTS} paths x 8 steps): williamson2n "
          f"launches={launches}, kernels vs plain max_abs_err={err:.3e} "
          f"bitwise={torch.equal(fused, plain)} (tolerance {tol:.1e})",
          flush=True)
    check(fused.shape == (SERVE_SLOTS, D_Z), "ODE result shape")
    check(bool(torch.isfinite(fused).all()), "ODE result not finite")
    check(err <= tol, "ODE kernel path disagrees with the plain path")
    check(launches > 0, "the ODE sdeint launched no williamson2n kernel")


def _max_rel(got, want):
    """max |got - want| / max(1, max |want|) over matching tensor lists."""
    return max((g.double().cpu() - w.double().cpu()).abs().max().item()
               / max(1.0, w.double().abs().max().item())
               for g, w in zip(got, want))


def _loss_err(got, want):
    """max relative loss error over the epochs; a non-finite loss must be
    non-finite on both sides (the guard then skipped the same updates)."""
    got, want = np.asarray(got), np.asarray(want)
    if not np.array_equal(np.isfinite(got), np.isfinite(want)):
        return float("inf")
    ok = np.isfinite(want)
    return float(np.max(np.abs(got[ok] - want[ok]) / np.abs(want[ok]),
                        initial=0.0))


def table1_phase(torch):
    """Phase 7: Table 1 on the card (repro_torch.benchmarks.table1_ou)."""
    from repro_torch.benchmarks import table1_ou as t1
    from repro_torch.core import prng
    from repro_torch.kernels import AXPY_CHAIN, KERNELS
    from repro_torch.nsde import init_lsde

    target = t1.target_paths()
    weights = init_lsde(prng.PRNGKey(0, device="cuda"), t1.D_OBS, t1.D_Z,
                        width=t1.WIDTH, device="cuda")

    # 7a. The first epochs of every solver: kernels vs the plain path on the
    # card (the forward is bitwise; the backward may sum in another order),
    # and vs a float32 CPU run of the plain path from the same weights
    # (torch's CPU and CUDA erfinv and matmuls differ in the last bits).
    for name, spec, n_steps in t1.solvers():
        plain = spec.split(":")[0]
        runs = {label: t1.train_one(s, n_steps, target, device=dev,
                                    epochs=CHECK_EPOCHS,
                                    params=copy.deepcopy(weights).to(dev))
                for label, s, dev in (("kernels", spec, "cuda"),
                                      ("plain", plain, "cuda"),
                                      ("cpu", plain, "cpu"))}
        k, p, c = runs["kernels"], runs["plain"], runs["cpu"]
        params = {key: list(r.params.parameters()) for key, r in runs.items()}
        kp_loss = _loss_err(k.losses, p.losses)
        kp_par = _max_rel(params["kernels"], params["plain"])
        kc_loss = _loss_err(k.losses, c.losses)
        kc_par = _max_rel(params["kernels"], params["cpu"])
        bitwise = k.losses == p.losses and all(
            torch.equal(a, b) for a, b in zip(params["kernels"], params["plain"]))
        print(f"  {name} ({spec}, {n_steps} steps), first {CHECK_EPOCHS} "
              f"epochs: losses {[f'{x:.6f}' for x in k.losses]}; kernels vs "
              f"plain on the card: loss {kp_loss:.2e}, params {kp_par:.2e} "
              f"(bitwise={bitwise}; tolerance 1e-5); vs the plain path on the "
              f"CPU: loss {kc_loss:.2e}, params {kc_par:.2e} (tolerance 1e-4 "
              f"relative)", flush=True)
        check(kp_loss <= 1e-5 and kp_par <= 1e-5,
              f"{name}: the kernel path trains unlike the plain path")
        check(kc_loss <= 1e-4 and kc_par <= 1e-4,
              f"{name}: the card trains unlike the CPU")

    # 7b. The main path: the reference's 60 epochs for every solver, with the
    # launch counts zeroed just before and read just after.
    for kern in KERNELS:
        kern.launches = 0
    by_entry = dict(AXPY_CHAIN.entry_launches)
    rows = {}
    for name, spec, n_steps in t1.solvers():
        before = {kern.name: kern.launches for kern in KERNELS}
        r = t1.train_one(spec, n_steps, target, device="cuda")
        per_step = {kern.name: (kern.launches - before[kern.name]) / t1.EPOCHS
                    for kern in KERNELS if kern.launches > before[kern.name]}
        rows[name] = r
        us = r.seconds / t1.EPOCHS * 1e6
        print(f"  table1_ou/{name}: terminal moment-MSE {r.loss:.6f} "
              f"(finite={np.isfinite(r.loss)}), {us:.1f} us per training step "
              f"({t1.EPOCHS} epochs x {t1.BATCH} paths x {n_steps} steps, "
              f"host wall clock), guard skipped {r.skipped} updates; kernel "
              f"launches per step {per_step}", flush=True)
    launches = {kern.name: kern.launches for kern in KERNELS}
    by_s = {fn[len("axpy_chain_"):]: n - by_entry.get(fn, 0)
            for fn, n in sorted(AXPY_CHAIN.entry_launches.items())
            if n > by_entry.get(fn, 0)}
    print(f"  axpy_chain launches of the 60-epoch runs by chain length: {by_s} "
          f"(total {launches['axpy_chain']})", flush=True)
    check(sum(by_s.values()) == launches["axpy_chain"],
          "axpy_chain's launches by chain length do not add up")
    check(all(np.isfinite(rows["EES(2,5)"].losses)),
          "EES(2,5) training went non-finite")

    # 7c. One step of each solver must not wait on the device.
    for name, spec, n_steps in t1.solvers():
        step, state, params, key = _train_step(torch, spec, n_steps, target)
        step(params, state, key)  # warm-up outside the check
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            step(params, state, key)
        except RuntimeError as exc:
            fail(f"a {spec} training step synchronized with the host: {exc}")
        finally:
            torch.cuda.set_sync_debug_mode("default")
    print("  one training step of each solver ran with "
          "torch.cuda.set_sync_debug_mode('error'): no host sync", flush=True)
    return launches


def _train_step(torch, spec, n_steps, target, n_paths=256, **kw):
    """A Table-1 training step of ``spec`` (and its state, weights and key);
    ``kw`` goes to ``make_sde_train_step``."""
    from repro_torch.benchmarks import table1_ou as t1
    from repro_torch.core import prng
    from repro_torch.nsde import init_lsde, lsde_readout, lsde_term, moment_mse
    from repro_torch.optim import adamw
    from repro_torch.train import make_sde_train_step

    params = init_lsde(0, t1.D_OBS, t1.D_Z, t1.WIDTH, device="cuda")
    tgt = torch.as_tensor(target, dtype=torch.float32, device="cuda")
    opt = adamw(1e-2)
    step = make_sde_train_step(
        spec, lsde_term(), opt,
        y0_fn=lambda p: torch.zeros(t1.D_Z, device="cuda") + p.encoder.b,
        loss_fn_result=lambda p, r: moment_mse(lsde_readout(p, r.ys)[..., 0], tgt),
        t0=0.0, t1=t1.T, n_steps=n_steps, n_paths=n_paths,
        save_every=n_steps // 2, device="cuda", **kw)
    return (step, opt.init(list(params.parameters())), params,
            prng.PRNGKey(1, device="cuda"))


def memory_phase(torch, timer):
    """Phase 8: peak memory of one EES(2,5) step, reversible vs full, and the
    profile of one reversible step."""
    from repro_torch.benchmarks import table1_ou as t1

    from repro_torch.core import TimeGrid, path_keys, prng
    from repro_torch.core.brownian import brownian_path

    target = t1.target_paths()

    def peak_mib(fn):
        """Peak device MiB allocated while ``fn`` runs, above what was
        allocated before it, and ``fn``'s result."""
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        out = fn()
        torch.cuda.synchronize()
        return (torch.cuda.max_memory_allocated() - base) / 2**20, out

    # "per-step noise" draws each step's increment in the loop (and again in
    # the backward sweep) instead of the bulk buffer: the adjoint alone.
    configs = (("reversible", dict(adjoint="reversible")),
               ("full", dict(adjoint="full")),
               ("reversible, per-step noise",
                dict(adjoint="reversible", bulk_increments=False)))
    peaks = {}
    for n_steps in (8, 64):
        for label, kw in configs:
            step, state, params, key = _train_step(
                torch, "ees25:use_kernels=True", n_steps, target,
                n_paths=SERVE_SLOTS, **kw)
            peak, (_, _, m) = peak_mib(lambda: step(params, state, key))
            peaks[(n_steps, label)] = peak
            check(bool(torch.isfinite(m["loss"])), f"{label} {n_steps}-step "
                  "training step at 65,536 paths is not finite")
            print(f"  EES(2,5) step, {SERVE_SLOTS} paths x {n_steps} steps, "
                  f"adjoint={label}: peak device memory {peak:.1f} MiB above "
                  f"what the step's inputs hold", flush=True)
        keys = path_keys(prng.PRNGKey(1, device="cuda"), SERVE_SLOTS)
        bm = brownian_path(keys, 0.0, t1.T, n_steps, shape=(D_Z,))
        ts = TimeGrid.from_path(bm).ts
        peaks[(n_steps, "realization")], _ = peak_mib(
            lambda: bm.grid_increments(ts))
        print(f"  the bulk increment realization alone ({n_steps} steps): "
              f"peak {peaks[(n_steps, 'realization')]:.1f} MiB for a "
              f"{n_steps * SERVE_SLOTS * D_Z * 4 / 2**20:.1f} MiB float32 buffer",
              flush=True)
    dws = (64 - 8) * SERVE_SLOTS * D_Z * 4 / 2**20
    growth = {label: peaks[(64, label)] - peaks[(8, label)]
              for label in [c[0] for c in configs] + ["realization"]}
    print(f"  growth from 8 to 64 steps (MiB): "
          + ", ".join(f"{k} {v:.1f}" for k, v in growth.items())
          + f"; the increment buffer itself grows by {dws:.1f}", flush=True)
    check(peaks[(64, "reversible")] < peaks[(64, "full")],
          "the reversible adjoint's peak is not below the full adjoint's")

    step, state, params, key = _train_step(
        torch, "ees25:use_kernels=True", 8, target, n_paths=SERVE_SLOTS)
    run = lambda: step(params, state, key)  # noqa: E731
    totals = timer.kernels_us(run, reps=3, flush=False)
    dev_ms = sum(t for t, _ in totals.values()) / 3 / 1e3
    n_launch = sum(n for _, n in totals.values()) // 3
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        start = time.perf_counter()
        run()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - start)
    wall_ms = min(walls) * 1e3
    print(f"  one reversible EES(2,5) training step ({SERVE_SLOTS} paths x 8 "
          f"steps): host wall {wall_ms:.3f} ms, device kernel time "
          f"{dev_ms:.3f} ms over {n_launch} launches (device busy "
          f"{dev_ms / wall_ms:.0%})", flush=True)
    rows = sorted(((t / 3, n // 3, name) for name, (t, n) in totals.items()),
                  reverse=True)
    for us, n, name in rows[:10]:
        print(f"    {us / 1e3:8.3f} ms {n:5d}x  {name[:100]}", flush=True)
    host_profile(torch, run, wall_ms)


def host_profile(torch, run, wall_ms):
    """Where one step's host time goes: the operators with the most host
    (self CPU) time, and their sum against the host wall."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        run()
        torch.cuda.synchronize()
    rows = sorted(prof.key_averages(), key=lambda e: e.self_cpu_time_total,
                  reverse=True)
    ops_ms = sum(e.self_cpu_time_total for e in rows) / 1e3
    print(f"  host, one profiled step: {ops_ms:.3f} ms of own CPU time over "
          f"all recorded events (the unprofiled step's wall is {wall_ms:.3f} "
          f"ms; an autograd Function's own time is its Python); top:",
          flush=True)
    for e in rows[:12]:
        print(f"    {e.self_cpu_time_total / 1e3:8.3f} ms {e.count:6d}x  "
              f"{e.key[:90]}", flush=True)


NOISE_T1, NOISE_STEPS = 1.0, 64  # the step-kernel benchmark's horizon
LM_CHECK_LAYERS = 12             # phase 11a: float32 depth (shared block at 0 and 6)
PREFILL_BATCH, PREFILL_LEN = 2, 2048
CPU_PATHS = 4096                 # paths of the CPU cross-checks


def _rel(got, want):
    """max |got - want| / max(1, max |want|) of two arrays."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(1.0, np.abs(want).max()))


def noise_serve_phase(torch, timer):
    """Phase 9: additive, general and diagonal SDEs served through the
    engine (requests E-N of the step-kernel benchmark's terms); returns the
    new kernels' launch counts."""
    from repro_torch.benchmarks import step_kernels as sk
    from repro_torch.core import PRNGKey, SDETerm, path_keys, sdeint
    from repro_torch.kernels import (INCREMENT_GENERAL, INCREMENT_PRE, KERNELS,
                                     WS_STAGE_GENERAL, WS_STAGE_PRE)
    from repro_torch.serving import BucketKey, SDESampleConfig, SDESampleEngine

    args = sk.term_args("cuda")
    additive = sk.make_term("prediffused")
    terms = {
        "additive": (additive, None),
        "relabel": (SDETerm(additive.drift, additive.diffusion, "diagonal"), None),
        "general": (sk.make_term("general"), (sk.N_CHANNELS,)),
        "diagonal": (sk.make_term("diagonal"), None),
    }
    y0 = torch.ones(sk.DIM, device="cuda")
    cfg = SDESampleConfig(slots=SERVE_SLOTS, ticks_per_dispatch=2,
                          guard_threshold=1e6)
    engines = {name: SDESampleEngine(term, y0, cfg, args=args, noise_shape=ns,
                                     device="cuda")
               for name, (term, ns) in terms.items()}
    # (label, engine, spec, paths, seed, the spec "auto" must resolve to)
    requests = [
        ("E", "additive", "ees25:use_kernels=True", 2 * SERVE_SLOTS, 21, None),
        ("F", "additive", "reversible-heun:use_kernels=True", SERVE_SLOTS, 22, None),
        ("H", "additive", "auto", SERVE_SLOTS, 24, "srk:noise='additive'"),
        ("I", "additive", "auto:stiffness=200", SERVE_SLOTS, 25, "ees27"),
        ("G", "relabel", "ees25", 2 * SERVE_SLOTS, 21, None),
        ("J", "general", "ees25:use_kernels=True", 2 * SERVE_SLOTS, 31, None),
        ("K", "general", "reversible-heun:use_kernels=True", SERVE_SLOTS, 32, None),
        ("L", "general", "ees25", 2 * SERVE_SLOTS, 31, None),
        ("M", "general", "auto", SERVE_SLOTS, 34, "ees25"),
        ("N", "diagonal", "auto", SERVE_SLOTS, 41, "milstein"),
    ]
    with torch.no_grad():
        # Warm-up: each request's spec once on its engine (allocator,
        # torch.func's first jvp, each route's first dispatch), outside the
        # count and the clock; its wall is the route's first-use cost.
        firsts = {}
        for label, eng, spec, _, _, _ in requests:
            torch.cuda.synchronize()
            start = time.perf_counter()
            engines[eng].submit(spec, t1=NOISE_T1, n_steps=NOISE_STEPS,
                                n_paths=1024, seed=99)
            engines[eng].run()
            torch.cuda.synchronize()
            firsts[label] = time.perf_counter() - start
        print("  warm-up, 1024 paths per request's spec (first use): "
              + ", ".join(f"{k} {v:.3f} s" for k, v in firsts.items()),
              flush=True)
        for kern in KERNELS:
            kern.launches = 0
        routes_before = general_routes()
        # One request at a time through its engine, each drain timed.
        rids, walls = {}, {}
        for label, eng, spec, n, seed, _ in requests:
            torch.cuda.synchronize()
            start = time.perf_counter()
            rids[label] = engines[eng].submit(spec, t1=NOISE_T1,
                                              n_steps=NOISE_STEPS, n_paths=n,
                                              seed=seed)
            engines[eng].run()
            torch.cuda.synchronize()
            walls[label] = time.perf_counter() - start
        done = {name: eng.done for name, eng in engines.items()}
    wall = sum(walls.values())
    launches = {k.name: k.launches for k in KERNELS if k.launches}
    routes = general_routes(since=routes_before)
    n_paths = sum(r[3] for r in requests)
    print(f"  served {len(requests)} requests, {n_paths} paths x "
          f"{NOISE_STEPS} steps in {wall:.3f} s: {n_paths / wall:.0f} paths/s "
          f"(host wall clock incl. delivery); kernel launches {launches}",
          flush=True)
    for label, eng, spec, n, _, _ in requests:
        print(f"    {label} ({eng}, {spec!r}, {n} paths): {walls[label]:.3f} s,"
              f" {n / walls[label]:.0f} paths/s", flush=True)
    # The same ten requests queued together and drained engine by engine:
    # queueing changes when a path is served, never its sample.
    with torch.no_grad():
        torch.cuda.synchronize()
        start = time.perf_counter()
        again = {label: engines[eng].submit(spec, t1=NOISE_T1,
                                            n_steps=NOISE_STEPS, n_paths=n,
                                            seed=seed)
                 for label, eng, spec, n, seed, _ in requests}
        for eng in engines.values():
            eng.run()
        torch.cuda.synchronize()
        queued_wall = time.perf_counter() - start
    same = all(np.array_equal(engines[eng].done[again[label]].y_final,
                              engines[eng].done[rids[label]].y_final)
               for label, eng, *_ in requests)
    print(f"  the same requests queued together: {queued_wall:.3f} s, "
          f"{n_paths / queued_wall:.0f} paths/s; samples bitwise equal to the "
          f"one-by-one drain: {same}", flush=True)
    check(same, "queueing the requests together changed their samples")
    res = {}
    for label, eng, spec, n, _, resolves in requests:
        r = done[eng][rids[label]]
        res[label] = r.y_final
        check(r.y_final.shape == (n, sk.DIM),
              f"request {label} y_final shape {r.y_final.shape}")
        check(bool(np.isfinite(r.y_final).all()),
              f"request {label} has non-finite samples")
        check(not r.diverged.any() and r.retries == 0,
              f"request {label} diverged")
        if resolves is not None:
            got = r.bucket.solver if r.bucket is not None else None
            print(f"  {label} ({eng}, {spec!r}) resolved to {got!r}",
                  flush=True)
            check(got == resolves, f"{spec!r} on the {eng} term resolved to "
                  f"{got!r}, not {resolves!r}")
    same = np.array_equal(res["E"], res["G"])
    print(f"  E (additive, prediffused kernels) vs G (diagonal relabel, "
          f"plain): bitwise={same}", flush=True)
    check(same, "the prediffused route differs from the diagonal relabel")
    jl = _rel(res["J"], res["L"])
    print(f"  J (general, kernels) vs L (plain, same seed): max rel err "
          f"{jl:.3e} (tolerance 1e-5; the kernel sums g@dW in another order "
          f"than einsum)", flush=True)
    check(jl <= 1e-5, "J and L disagree")
    for label, key, seed in (("E", "additive", 21), ("J", "general", 31)):
        term, ns = terms[key]
        cpu_args = {k: v.cpu() for k, v in args.items()}
        with torch.no_grad():
            ref = sdeint(term, "ees25", 0.0, NOISE_T1, NOISE_STEPS, y0.cpu(),
                         args=cpu_args, noise_shape=ns,
                         batch_keys=path_keys(PRNGKey(seed, device="cpu"),
                                              CPU_PATHS),
                         device="cpu").y_final
        err = _rel(res[label][:CPU_PATHS], ref.numpy())
        print(f"  {label}[:{CPU_PATHS}] vs the plain path on the CPU: max rel "
              f"err {err:.3e} (tolerance 1e-4)", flush=True)
        check(err <= 1e-4, f"{label} disagrees with the CPU run")
    for kern in (WS_STAGE_PRE, INCREMENT_PRE, WS_STAGE_GENERAL,
                 INCREMENT_GENERAL):
        check(launches.get(kern.name, 0) > 0,
              f"serving launched no {kern.name} kernel")

    # One bucketed tick of each route: device time and no host sync.
    for label, key, spec in (("E", "additive", "ees25:use_kernels=True"),
                             ("J", "general", "ees25:use_kernels=True"),
                             ("H", "additive", "srk:noise='additive'"),
                             ("N", "diagonal", "milstein")):
        eng = engines[key]
        bucket = BucketKey(spec, 0.0, NOISE_T1 / NOISE_STEPS, NOISE_STEPS)
        keys = path_keys(PRNGKey(7, device="cuda"), SERVE_SLOTS)[None]

        def dispatch():
            return eng.executor.dispatch(bucket, keys, (NOISE_STEPS,))

        with torch.no_grad():
            totals = timer.kernels_us(dispatch, reps=3, flush=False)
            walls = []
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                dispatch()
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
            torch.cuda.set_sync_debug_mode("error")
            try:
                dispatch()
            except RuntimeError as exc:
                fail(f"a {label} dispatch synchronized with the host: {exc}")
            finally:
                torch.cuda.set_sync_debug_mode("default")
        dev_ms = sum(t for t, _ in totals.values()) / 3 / 1e3
        n_launch = sum(n for _, n in totals.values()) // 3
        wall_ms = min(walls) * 1e3
        print(f"  one {label} tick ({SERVE_SLOTS} paths x {NOISE_STEPS} "
              f"steps): host wall {wall_ms:.3f} ms, device kernel time "
              f"{dev_ms:.3f} ms over {n_launch} launches (device busy "
              f"{dev_ms / wall_ms:.0%}); no host sync in the dispatch",
              flush=True)
        rows = sorted(((t / 3, n // 3, name) for name, (t, n) in totals.items()),
                      reverse=True)
        for us, n, name in rows[:6]:
            print(f"    {us / 1e3:8.3f} ms {n:5d}x  {name[:100]}", flush=True)
    wide, wide_routes = wide_general_request(torch, timer)
    for name, n in wide.items():
        launches[name] = launches.get(name, 0) + n
    for name, by_route in wide_routes.items():
        routes[name] = {r: routes[name][r] + n for r, n in by_route.items()}
    return launches, routes


WIDE_CHANNELS = 128  # the reference kernel's lane-aligned width (its m % 128 == 0)


def general_routes(since=None):
    """``{kernel: {route: launches}}`` of the two general-noise kernels, less
    the counts in ``since``."""
    from repro_torch.kernels import INCREMENT_GENERAL, WS_STAGE_GENERAL
    from repro_torch.kernels.sde_step.sde_step import route_launches

    now = {k.name: route_launches(k) for k in (INCREMENT_GENERAL, WS_STAGE_GENERAL)}
    if since is None:
        return now
    return {name: {r: n - since[name][r] for r, n in by.items()} for name, by in now.items()}


def wide_general_request(torch, timer):
    """Phase 9's general-noise request at the reference kernel's width:
    65,536 paths of the step-kernel benchmark's general term (d = 16) with
    m = 128 channels, ``ees25:use_kernels=True`` against plain ``ees25`` on
    the same seed (1e-5), with the device ms of one tick of each; returns the
    kernels' launches and the general kernels' launches by route."""
    from repro_torch.benchmarks import step_kernels as sk
    from repro_torch.core import PRNGKey, path_keys
    from repro_torch.kernels import KERNELS
    from repro_torch.serving import BucketKey, SDESampleConfig, SDESampleEngine

    term = sk.make_term("general", channels=WIDE_CHANNELS)
    cfg = SDESampleConfig(slots=SERVE_SLOTS, ticks_per_dispatch=2, guard_threshold=1e6)
    eng = SDESampleEngine(term, torch.ones(sk.DIM, device="cuda"), cfg,
                          args=sk.term_args("cuda"), noise_shape=(WIDE_CHANNELS,),
                          device="cuda")
    specs = ("ees25:use_kernels=True", "ees25")
    with torch.no_grad():
        for spec in specs:  # first use at full size, outside the count and the clock
            eng.submit(spec, t1=NOISE_T1, n_steps=NOISE_STEPS, n_paths=SERVE_SLOTS, seed=99)
            eng.run()
        torch.cuda.synchronize()
        for kern in KERNELS:
            kern.launches = 0
        routes_before = general_routes()
        rids, walls = {}, {}
        for spec in specs:
            start = time.perf_counter()
            rids[spec] = eng.submit(spec, t1=NOISE_T1, n_steps=NOISE_STEPS,
                                    n_paths=SERVE_SLOTS, seed=51)
            eng.run()
            torch.cuda.synchronize()
            walls[spec] = time.perf_counter() - start
    launches = {k.name: k.launches for k in KERNELS if k.launches}
    routes = general_routes(since=routes_before)
    got, want = (eng.done[rids[s]] for s in specs)
    for r in (got, want):
        check(r.y_final.shape == (SERVE_SLOTS, sk.DIM) and bool(np.isfinite(r.y_final).all())
              and not r.diverged.any(), "the m = 128 request returned a bad sample")
    err = _rel(got.y_final, want.y_final)
    print(f"  m = {WIDE_CHANNELS} request ({SERVE_SLOTS} paths, d = {sk.DIM}, "
          f"{NOISE_STEPS} steps): {specs[0]!r} vs {specs[1]!r}, same seed: max rel err "
          f"{err:.3e} (tolerance 1e-5); drains {walls[specs[0]]:.3f} s and "
          f"{walls[specs[1]]:.3f} s (host wall); kernel launches {launches}, general "
          f"kernels by route {routes}", flush=True)
    check(err <= 1e-5, "the m = 128 request: the kernel route disagrees with the plain route")
    check(routes["ws_stage_general"]["staged"] > 0,
          "the m = 128 request launched no ws_stage_general kernel on the staged route")
    keys = path_keys(PRNGKey(7, device="cuda"), SERVE_SLOTS)[None]
    for spec in specs:
        bucket = BucketKey(spec, 0.0, NOISE_T1 / NOISE_STEPS, NOISE_STEPS)
        with torch.no_grad():
            totals = timer.kernels_us(
                lambda: eng.executor.dispatch(bucket, keys, (NOISE_STEPS,)), reps=2,
                flush=False)
        dev_ms = sum(us for us, _ in totals.values()) / 2 / 1e3
        general_ms = sum(us for name, (us, _) in totals.items()
                         if "general_kernel" in name) / 2 / 1e3
        print(f"  one m = {WIDE_CHANNELS} tick, {spec!r} ({SERVE_SLOTS} paths x "
              f"{NOISE_STEPS} steps): device kernel time {dev_ms:.3f} ms, "
              f"{general_ms:.3f} ms of it in the general-noise kernels", flush=True)
        rows = sorted(((us / 2, n // 2, name) for name, (us, n) in totals.items()),
                      reverse=True)
        for us, n, name in rows[:4]:
            print(f"    {us / 1e3:8.3f} ms {n:5d}x  {name[:100]}", flush=True)
    return launches, routes


def noise_train_phase(torch):
    """Phase 10: three training steps of the OU model on the additive term
    (full adjoint, prediffused kernels) and the general term (reversible
    adjoint, EES(2,5) and Reversible Heun kernels), each against the plain
    route; returns the new kernels' launch counts."""
    from repro_torch.benchmarks import step_kernels as sk
    from repro_torch.core import SDETerm, prng
    from repro_torch.kernels import (INCREMENT_GENERAL, KERNELS, WS_STAGE_GENERAL,
                                     WS_STAGE_PRE)
    from repro_torch.nsde import moment_mse, ou_paths
    from repro_torch.optim import adamw
    from repro_torch.train import make_sde_train_step

    n_paths, save_every = 4096, 16
    target = torch.as_tensor(
        ou_paths(np.random.default_rng(0), 4096, NOISE_STEPS, T=NOISE_T1,
                 nu=0.2, mu=0.1, sigma=0.8)[:, save_every::save_every],
        dtype=torch.float32, device="cuda")
    additive = sk.make_term("prediffused")
    relabel = SDETerm(additive.drift, additive.diffusion, "diagonal")
    general = sk.make_term("general")

    def make(term, spec, adjoint, ns):
        params = torch.nn.ParameterDict({
            k: torch.nn.Parameter(torch.tensor(v, device="cuda"))
            for k, v in (("nu", 0.5), ("mu", 0.0), ("sigma", 0.5))})
        opt = adamw(1e-2)
        step = make_sde_train_step(
            spec, term, opt, y0_fn=lambda p: torch.zeros(sk.DIM, device="cuda"),
            loss_fn_result=lambda p, r: moment_mse(r.ys[..., 0], target),
            t0=0.0, t1=NOISE_T1, n_steps=NOISE_STEPS, n_paths=n_paths,
            save_every=save_every, adjoint=adjoint, noise_shape=ns,
            device="cuda")
        return step, params, opt.init(list(params.parameters()))

    def train(term, spec, adjoint, ns=None, steps=3):
        step, params, state = make(term, spec, adjoint, ns)
        losses = []
        for i in range(steps):
            params, state, m = step(params, state,
                                    prng.PRNGKey(i, device="cuda"))
            check(not bool(m["skipped"]), f"{spec} skipped an update")
            losses.append(m["loss"].item())
        return losses, [p.detach().clone() for p in params.parameters()]

    cases = [
        ("additive, full adjoint, prediffused", additive, relabel,
         "ees25:use_kernels=True", "ees25", "full", None, WS_STAGE_PRE),
        ("general, reversible adjoint, EES(2,5)", general, general,
         "ees25:use_kernels=True", "ees25", "reversible", (sk.N_CHANNELS,),
         WS_STAGE_GENERAL),
        ("general, reversible adjoint, Reversible Heun", general, general,
         "reversible-heun:use_kernels=True", "reversible-heun", "reversible",
         (sk.N_CHANNELS,), INCREMENT_GENERAL),
    ]
    for kern in KERNELS:
        kern.launches = 0
    routes_before = general_routes()
    for label, term, plain_term, spec, plain, adjoint, ns, kern in cases:
        before = kern.launches
        t0 = time.perf_counter()
        k_loss, k_par = train(term, spec, adjoint, ns)
        seconds = time.perf_counter() - t0
        p_loss, p_par = train(plain_term, plain, adjoint, ns)
        bitwise = k_loss == p_loss and all(
            torch.equal(a, b) for a, b in zip(k_par, p_par))
        loss_err = _loss_err(k_loss, p_loss)
        par_err = _max_rel(k_par, p_par)
        print(f"  {label} ({spec}, {n_paths} paths x {NOISE_STEPS} steps): "
              f"losses {[f'{x:.6f}' for x in k_loss]}, {seconds / 3 * 1e3:.1f}"
              f" ms per training step (host wall); vs {plain!r} "
              f"{'on the diagonal relabel' if term is additive else 'plain'}: "
              f"loss {loss_err:.2e}, params {par_err:.2e}, bitwise={bitwise}; "
              f"{kern.name} launches {kern.launches - before}", flush=True)
        check(kern.launches > before, f"{label}: no {kern.name} launch")
        if term is additive:
            check(bitwise, "the prediffused route trains unlike the diagonal "
                  "relabel")
        else:
            check(loss_err <= 1e-5 and par_err <= 1e-5,
                  f"{label}: the kernel route trains unlike the plain route")
    launches = {k.name: k.launches for k in KERNELS if k.launches}
    routes = general_routes(since=routes_before)

    for label, term, _, spec, _, adjoint, ns, _ in cases:
        step, params, state = make(term, spec, adjoint, ns)
        key = prng.PRNGKey(0, device="cuda")
        step(params, state, key)  # warm-up outside the check
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            step(params, state, key)
        except RuntimeError as exc:
            fail(f"a {label} training step synchronized with the host: {exc}")
        finally:
            torch.cuda.set_sync_debug_mode("default")
    print("  one training step of each case ran with "
          "torch.cuda.set_sync_debug_mode('error'): no host sync", flush=True)
    return launches, routes


def _rel_to_max(torch, got, want) -> float:
    """max |got - want| / max |want| (on the device of ``want``)."""
    got = got.to(want.device).float()
    want = want.float()
    return (got - want).abs().max().item() / want.abs().max().item()


def _lm_tokens(torch, cfg, b, s, seed):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, cfg.vocab, size=(b, s))).to("cuda")


def lm_float32_phase(torch):
    """Phase 11a: zamba2-7b at full width in float32, 12 layers (the shared
    block at layers 0 and 6): the kernel path against the plain path, the
    full forward against token-by-token decode, and the card against a CPU
    run of the plain path on the same weights."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.core import prng
    from repro_torch.kernels import FLASH_ATTENTION, SSD_SCAN
    from repro_torch.kernels.flash_attention.flash_attention import ROUTE_LAUNCHES
    from repro_torch.models import (LMParams, ModelOptions, forward, init_cache,
                                    init_params, serve_step)

    cfg = dataclasses.replace(get_arch("zamba2-7b"), n_layers=LM_CHECK_LAYERS,
                              dtype="float32")
    start = time.perf_counter()
    params = init_params(cfg, prng.PRNGKey(0, device="cuda"), device="cuda")
    torch.cuda.synchronize()
    print(f"  zamba2-7b float32, {cfg.n_layers} layers at full width "
          f"(d_model {cfg.d_model}, {cfg.n_heads} heads of {cfg.resolved_head_dim}, "
          f"{cfg.ssm_heads} SSM heads, state {cfg.ssm_state}): "
          f"{sum(p.numel() for p in params.parameters()) / 1e9:.3f} B parameters "
          f"drawn in {time.perf_counter() - start:.2f} s", flush=True)
    B, S = 2, 256
    toks = _lm_tokens(torch, cfg, B, S, seed=11)
    with torch.no_grad():
        FLASH_ATTENTION.launches = SSD_SCAN.launches = 0
        ROUTE_LAUNCHES.update(dict.fromkeys(ROUTE_LAUNCHES, 0))
        kern, _ = forward(cfg, params, {"tokens": toks})
        torch.cuda.synchronize()
        launched = (FLASH_ATTENTION.launches, SSD_SCAN.launches)
        routes = dict(ROUTE_LAUNCHES)
        plain, _ = forward(cfg, params, {"tokens": toks}, ModelOptions(use_flash="never"))
        kp = _rel_to_max(torch, kern, plain)
        check(launched == (2, LM_CHECK_LAYERS), f"the float32 forward launched "
              f"(flash_attention, ssd_scan) = {launched}, not (2, {LM_CHECK_LAYERS})")
        check(routes == {"wgmma": 0, "mma_tf32": 2, "simt": 0},
              f"the float32 forward's attention took the routes {routes}")
        check(kern.shape == (B, S, cfg.vocab) and bool(torch.isfinite(kern).all()),
              "the float32 forward's logits are not finite of shape (B, S, V)")
        print(f"  B={B} S={S}: kernel path (flash_attention {launched[0]} launches, "
              f"by route {routes}; ssd_scan {launched[1]}) vs plain path: {kp:.3e} of "
              f"max|logit|="
              f"{plain.abs().max().item():.4g} (tolerance 1e-4)", flush=True)
        check(kp <= 1e-4, "the kernel path disagrees with the plain path")
        lm_bf16_check(torch, cfg, toks, plain)

        cache = init_cache(cfg, B, S, device="cuda")
        start = time.perf_counter()
        steps = [serve_step(cfg, params, cache, toks[:, i], i)[0] for i in range(S)]
        torch.cuda.synchronize()
        dec = _rel_to_max(torch, torch.stack(steps, dim=1), kern)
        print(f"  token-by-token serve_step ({S} steps, {time.perf_counter() - start:.2f}"
              f" s) vs the kernel-path forward: {dec:.3e} of max|logit| (tolerance "
              f"1e-4)", flush=True)
        check(dec <= 1e-4, "decode disagrees with the forward")
        del steps, cache, plain

        n_cpu = LM_CHECK_LAYERS // 2
        cfg_cpu = dataclasses.replace(cfg, n_layers=n_cpu)
        sub = LMParams(params.embed, list(params.layers[:n_cpu]), params.shared,
                       params.final_norm, params.lm_head)
        toks1 = toks[:1, :128]
        card, _ = forward(cfg_cpu, sub, {"tokens": toks1})
        start = time.perf_counter()
        host = copy.deepcopy(sub).to("cpu")
        ref, _ = forward(cfg_cpu, host, {"tokens": toks1.cpu()},
                         ModelOptions(use_flash="never"))
        cpu_rel = _rel_to_max(torch, card.cpu(), ref)
        print(f"  {n_cpu} layers, B=1 S=128: the card (kernel path) vs the plain path "
              f"on the CPU ({time.perf_counter() - start:.2f} s): {cpu_rel:.3e} of "
              f"max|logit| (tolerance 1e-4)", flush=True)
        check(cpu_rel <= 1e-4, "the card disagrees with the CPU")
    del params, sub, host, kern, card
    torch.cuda.empty_cache()


def lm_bf16_check(torch, cfg, toks, ref):
    """Phase 11a, bf16: the same 12 layers and tokens with the same draws in
    bf16 (the bf16 config: matrices rounded to bf16, the SSM's A, D and dt
    bias kept in float32), through the kernels (flash_attention's wgmma
    route) and through the plain path, each against the float32 plain path
    ``ref``: the kernel path's distance may be at most twice the plain
    path's plus 1e-3 of max|logit|."""
    import dataclasses

    from repro_torch.core import prng
    from repro_torch.kernels.flash_attention.flash_attention import ROUTE_LAUNCHES
    from repro_torch.models import ModelOptions, forward, init_params

    low = init_params(dataclasses.replace(cfg, dtype="bfloat16"),
                      prng.PRNGKey(0, device="cuda"), device="cuda")
    ROUTE_LAUNCHES.update(dict.fromkeys(ROUTE_LAUNCHES, 0))
    kern, _ = forward(cfg, low, {"tokens": toks})
    torch.cuda.synchronize()
    routes = dict(ROUTE_LAUNCHES)
    plain, _ = forward(cfg, low, {"tokens": toks}, ModelOptions(use_flash="never"))
    scale = ref.abs().max().item()
    d_kern = (kern.float() - ref).abs().max().item()
    d_plain = (plain.float() - ref).abs().max().item()
    limit = 2 * d_plain + 1e-3 * scale
    print(f"  bf16 weights, same {cfg.n_layers} layers and tokens: kernel path "
          f"(flash_attention routes {routes}) vs the float32 plain path "
          f"{d_kern:.4g}, bf16 plain path vs it {d_plain:.4g} (max|logit| "
          f"{scale:.4g}; the kernel path's limit 2 x {d_plain:.4g} + 1e-3 x "
          f"max|logit| = {limit:.4g})", flush=True)
    check(routes == {"wgmma": 2, "mma_tf32": 0, "simt": 0},
          f"the bf16 forward's attention took the routes {routes}")
    check(bool(torch.isfinite(kern).all()), "the bf16 kernel path's logits are not finite")
    check(d_kern <= limit, "the bf16 kernel path is further from the float32 "
          "plain path than the bf16 plain path allows")
    del low, kern, plain


def lm_prefill_phase(torch, timer):
    """Phase 11b: zamba2-7b in bf16 at full width and depth: prefill of
    B=2 x 2048 tokens through the kernels; returns (params, launches)."""
    from repro_torch.configs import get_arch
    from repro_torch.core import prng
    from repro_torch.kernels import FLASH_ATTENTION, SSD_SCAN
    from repro_torch.kernels.flash_attention.flash_attention import ROUTE_LAUNCHES
    from repro_torch.models import forward, init_params

    cfg = get_arch("zamba2-7b")
    start = time.perf_counter()
    params = init_params(cfg, prng.PRNGKey(0, device="cuda"), device="cuda")
    torch.cuda.synchronize()
    n_par = sum(p.numel() for p in params.parameters())
    print(f"  zamba2-7b bf16, all {cfg.n_layers} layers: {n_par / 1e9:.3f} B "
          f"parameters ({torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated) "
          f"drawn with init_params(PRNGKey(0)) in {time.perf_counter() - start:.2f} s",
          flush=True)
    B, S = PREFILL_BATCH, PREFILL_LEN
    toks = _lm_tokens(torch, cfg, B, S, seed=12)

    def prefill():
        return forward(cfg, params, {"tokens": toks}, head_positions="last")[0]

    with torch.no_grad():
        prefill()  # warm-up: first launches, cuBLAS handles, the allocator
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        FLASH_ATTENTION.launches = SSD_SCAN.launches = 0
        ROUTE_LAUNCHES.update(dict.fromkeys(ROUTE_LAUNCHES, 0))
        logits = prefill()
        torch.cuda.synchronize()
        launches = {"flash_attention": FLASH_ATTENTION.launches,
                    "ssd_scan": SSD_SCAN.launches}
        routes = dict(ROUTE_LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
        check(logits.shape == (B, 1, cfg.vocab) and bool(torch.isfinite(logits).all()),
              "the bf16 prefill's logits are not finite of shape (B, 1, V)")
        n_inv = -(-cfg.n_layers // cfg.shared_attn_every)
        print(f"  one prefill (B={B}, S={S}, head_positions='last'): launches "
              f"{launches} (expected {n_inv} and {cfg.n_layers}); peak device memory "
              f"{peak / 2**30:.2f} GiB ({(peak - base) / 2**30:.2f} GiB above the "
              f"weights and inputs)", flush=True)
        check(launches == {"flash_attention": n_inv, "ssd_scan": cfg.n_layers},
              f"the prefill's kernel launches are {launches}")
        print(f"  flash_attention launches by route: {routes}", flush=True)
        check(routes == {"wgmma": n_inv, "mma_tf32": 0, "simt": 0},
              f"the prefill's attention took the routes {routes}, not wgmma only")
        walls = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            prefill()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        wall = sorted(walls)[1]
        print(f"  prefill wall (host clock, synchronized): "
              f"{', '.join(f'{w * 1e3:.1f}' for w in walls)} ms; median "
              f"{wall * 1e3:.1f} ms = {B * S / wall:.0f} tokens/s", flush=True)
        totals = timer.kernels_us(prefill, reps=1, flush=False)
        dev_ms = sum(t for t, _ in totals.values()) / 1e3
        groups = {"flash_attention": 0.0, "ssd_scan": 0.0, "GEMM": 0.0, "other": 0.0}
        for name, (us, _) in totals.items():
            low = name.lower()
            key = ("flash_attention" if "flash_attention_kernel" in name else
                   "ssd_scan" if "ssd_scan_kernel" in name else
                   "GEMM" if any(t in low for t in ("gemm", "nvjet", "xmma", "cutlass"))
                   else "other")
            groups[key] += us / 1e3
        print(f"  one profiled prefill: {dev_ms:.2f} ms of device time over "
              f"{sum(n for _, n in totals.values())} launches (device busy "
              f"{dev_ms / (wall * 1e3):.0%} of the median wall); by kind: "
              + ", ".join(f"{k} {v:.2f} ms ({v / dev_ms:.0%})" for k, v in groups.items()),
              flush=True)
        rows = sorted(((t, n, name) for name, (t, n) in totals.items()), reverse=True)
        for us, n, name in rows[:10]:
            print(f"    {us / 1e3:8.3f} ms {n:5d}x  {name[:100]}", flush=True)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            prefill()
        except RuntimeError as exc:
            fail(f"the prefill synchronized with the host: {exc}")
        finally:
            torch.cuda.set_sync_debug_mode("default")
        print("  a prefill ran with torch.cuda.set_sync_debug_mode('error'): no "
              "host sync", flush=True)
    return cfg, params, launches


def lm_serve_phase(torch, timer, cfg, params):
    """Phase 12: zamba2-7b (bf16, full width and depth) served by the decode
    Engine: 8 requests of 8-token prompts, greedy, twice."""
    from repro_torch.serving import Engine, ServeConfig

    prompts = np.random.default_rng(13).integers(2, cfg.vocab, size=(8, 8)).tolist()

    def drain():
        eng = Engine(cfg, params, ServeConfig(slots=8, max_len=64))
        step, finite, ticks = eng._step, [], [0]

        def counted(*args):
            logits, cache = step(*args)
            finite.append(torch.isfinite(logits).all())
            ticks[0] += 1
            return logits, cache

        eng._step = counted
        for p in prompts:
            eng.submit(p)
        torch.cuda.synchronize()
        start = time.perf_counter()
        done = eng.run()
        torch.cuda.synchronize()
        return done, time.perf_counter() - start, ticks[0], bool(torch.stack(finite).all())

    first, wall, ticks, finite = drain()
    new = sum(len(t) - len(p) for t, p in zip(first.values(), prompts))
    print(f"  Engine(slots=8, max_len=64), 8 requests x 8-token prompts, greedy: "
          f"{new} new tokens in {ticks} ticks, {wall:.3f} s = {new / wall:.1f} "
          f"tokens/s ({wall / ticks * 1e3:.1f} ms a tick, host wall clock incl. "
          f"the token-by-token prefill); logits finite: {finite}", flush=True)
    check(finite, "the served logits are not finite")
    check(len(first) == 8 and all(t[:8] == p for t, p in
                                  zip((first[i] for i in range(8)), prompts)),
          "the engine did not finish the 8 requests")
    second, wall2, _, _ = drain()
    same = second == first
    print(f"  a second drain of the same requests on a new engine ({wall2:.3f} s, "
          f"{new / wall2:.1f} tokens/s): the same tokens: {same}", flush=True)
    check(same, "a second drain returned other tokens")
    print(f"  request 0: prompt {prompts[0]} -> {first[0][8:16]} ...", flush=True)
    tick_profile(torch, timer, cfg, params)


def tick_profile(torch, timer, cfg, params):
    """One decode step of 8 slots: host wall, device time, launches."""
    from repro_torch.models import init_cache, serve_step

    cache = init_cache(cfg, 8, 64, device="cuda")
    toks = torch.full((8,), 7, dtype=torch.int64, device="cuda")

    def step():
        return serve_step(cfg, params, cache, toks, 9)

    with torch.no_grad():
        totals = timer.kernels_us(step, reps=3, flush=False)
        walls = []
        for _ in range(3):
            torch.cuda.synchronize()
            start = time.perf_counter()
            step()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - start)
    dev_ms = sum(t for t, _ in totals.values()) / 3 / 1e3
    launches = sum(n for _, n in totals.values()) // 3
    wall_ms = min(walls) * 1e3
    print(f"  one serve_step (8 slots, {cfg.n_layers} layers): host wall {wall_ms:.3f} "
          f"ms, device kernel time {dev_ms:.3f} ms over {launches} launches "
          f"(device busy {dev_ms / wall_ms:.0%}; {wall_ms / launches * 1e3:.1f} us of "
          f"host per launch)", flush=True)


def main() -> int:
    try:
        import torch
    except ImportError:
        print("torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("no CUDA device: chip_smoke.py runs the port on a GPU",
              file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print("src/repro_torch not found beside chip_smoke.py: run it from a "
              "checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, SRC)
    t_start = time.perf_counter()

    print("phase 1: device", flush=True)
    card = card_line()
    print(f"  card: {card}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    print(f"  torch {torch.__version__} (CUDA {torch.version.cuda}) on "
          f"{torch.cuda.get_device_name(0)}; TF32 off: "
          f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}; bf16 GEMMs reduce "
          f"in float32: allow_bf16_reduced_precision_reduction="
          f"{torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction}",
          flush=True)

    print("phase 2: build", flush=True)
    from repro_torch.kernels import KERNELS, WILLIAMSON2N, WS_STAGE_DIAG, build_kernels
    seconds = build_kernels()
    print(f"  built {len(KERNELS)} kernel libraries in {seconds:.2f} s", flush=True)
    for k in KERNELS:
        for line in k.build_log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {k.name}: {line.strip()}", flush=True)

    print("phase 3: kernels against their plain twins", flush=True)
    timer = Timer(torch)
    stats = kernel_phase(torch, timer)
    stats.update(lm_kernel_phase(torch, timer))

    print("phase 4: serve requests A-D", flush=True)
    params, _ = serve_phase(torch, timer)
    ws_launches = WS_STAGE_DIAG.launches

    print("phase 5: ODE sdeint through williamson2n", flush=True)
    ode_phase(torch, params)

    launches = {"ws_stage_diag": WS_STAGE_DIAG.launches,
                "williamson2n": WILLIAMSON2N.launches}
    print(f"phase 6: kernels launched on the main path (phases 4-5): "
          f"{launches} (ws_stage_diag {ws_launches} of them while serving)",
          flush=True)
    for name, n in launches.items():
        check(n > 0, f"{name} was not launched on the main path")

    print("phase 7: Table 1 on the card", flush=True)
    train_launches = table1_phase(torch)
    print(f"  kernels launched on the training path (phase 7's 60-epoch runs): "
          f"{train_launches}", flush=True)
    for name in ("ws_stage_diag_bwd", "increment_diag", "axpy_chain",
                 "ws_stage_diag"):
        check(train_launches[name] > 0,
              f"{name} was not launched on the training path")
    launches.update({name: train_launches[name] for name in
                     ("ws_stage_diag_bwd", "increment_diag", "axpy_chain")})

    print("phase 8: reversible vs full adjoint memory; one step's profile",
          flush=True)
    memory_phase(torch, timer)

    print("phase 9: serve additive, general and diagonal SDEs (requests E-N)",
          flush=True)
    serve_launches, serve_routes = noise_serve_phase(torch, timer)

    print("phase 10: train on the additive and general terms", flush=True)
    noise_train_launches, train_routes = noise_train_phase(torch)
    new = ("increment_pre", "ws_stage_pre", "increment_general",
           "ws_stage_general")
    launches.update({name: serve_launches.get(name, 0)
                     + noise_train_launches.get(name, 0) for name in new})
    by_route = {name: {r: n + train_routes[name][r] for r, n in routes.items()}
                for name, routes in serve_routes.items()}
    print(f"  kernels launched on the noise-specialised paths (phases 9-10): "
          f"serving {serve_launches}, training {noise_train_launches}; the general "
          f"kernels by route {by_route}", flush=True)

    print("phase 11: LM prefill, zamba2-7b at full width", flush=True)
    lm_float32_phase(torch)
    cfg, lm_params, prefill_launches = lm_prefill_phase(torch, timer)
    launches.update(prefill_launches)

    print("phase 12: LM serving, zamba2-7b at full width (bf16)", flush=True)
    lm_serve_phase(torch, timer, cfg, lm_params)

    tpu = "src/repro/kernels/sde_step/sde_step.py"
    sources = {"ws_stage_diag": ("ws_stage_diag.cu", f"{tpu}:144"),
               "williamson2n": ("williamson2n.cu",
                                "src/repro/kernels/williamson2n/williamson2n.py:56"),
               "ws_stage_diag_bwd": ("ws_stage_diag_bwd.cu", f"{tpu}:182"),
               "increment_diag": ("increment_diag.cu", f"{tpu}:65"),
               "axpy_chain": ("axpy_chain.cu", f"{tpu}:286"),
               "increment_pre": ("increment_pre.cu", f"{tpu}:85"),
               "ws_stage_pre": ("ws_stage_pre.cu", f"{tpu}:212"),
               "increment_general": ("increment_general.cu", f"{tpu}:112"),
               "ws_stage_general": ("ws_stage_general.cu", f"{tpu}:247"),
               "flash_attention": ("flash_attention.cu", "src/repro/kernels/"
                                   "flash_attention/flash_attention.py:119"),
               "ssd_scan": ("ssd_scan.cu", "src/repro/kernels/ssd_scan/ssd_scan.py:84")}
    record = {"kernels": [
        {"name": name, "route": "cuda",
         "source": f"src/repro_torch/csrc/{sources[name][0]}",
         "replaces": sources[name][1], "launches": launches[name],
         "max_abs_err": stats[name]["max_abs_err"], "ms": stats[name]["ms"],
         "plain_ms": stats[name]["plain_ms"],
         "bound_ms": stats[name]["bound_ms"],
         "bound_by": stats[name]["bound_by"],
         "library_ms": stats[name]["library_ms"],
         **({"launches_by_route": by_route[name]} if name in by_route else {})}
        for name in sources]}
    print(f"  total {time.perf_counter() - t_start:.1f} s", flush=True)
    print(f"card: {card}", flush=True)
    print(json.dumps(record), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
