#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

Run from the root of a checkout, with no arguments::

    python3 chip_smoke.py

It drives the port's two paths through the hand-written CUDA kernels — an
``SDESampleEngine`` serving EES(2,5) and EES(2,7) Monte-Carlo sampling
requests of the neural Langevin SDE at its Table-1 widths (``d_obs=1,
d_z=16, width=32``) plus an ODE-mode ``sdeint``, and the paper's Table-1
training run with the reversible adjoint — and checks what comes out:

1. the card (``nvidia-smi`` name and power limit); TF32 off;
2. the kernel builds (one ``nvcc`` per source, in parallel);
3. each kernel against its plain PyTorch twin on the card, float32 and
   float64, at the served (or trained) shape, a ragged size and an
   unaligned view, with its time, the twin's time and its byte bound;
4. serving requests A-D (A and B share a padded bucket; D is A's seed on the
   plain path), with shapes, finiteness, A against D, A against a CPU run of
   the plain path, paths/s, dispatch counts and a profile of one dispatch;
5. an ODE-mode ``sdeint`` through the ``williamson2n`` kernel against the
   plain path;
6. the serving path's launch counts;
7. Table 1 on the card: the four ``:use_kernels=True`` solvers trained for
   the reference's 60 epochs at 256 paths, after their first epochs are
   held against the plain path on the card and on the CPU; one step of
   each under ``torch.cuda.set_sync_debug_mode("error")``;
8. one EES(2,5) training step at 65,536 paths under the reversible and the
   full adjoint, 8 and 64 steps: peak device memory, and the profile of one
   reversible step.

The launch counts are zeroed just before each path (phases 4-5, and the
60-epoch runs of phase 7) and read just after; a kernel of the path with no
launch there fails the run.  The second-to-last line is the
``{"kernels": [...]}`` record and the last line ``{"ok": true, "device":
{...}}``.  Any failed phase exits non-zero; with no
CUDA device, or without the ``src/repro_torch`` package beside this script,
it exits non-zero before printing any result.  It imports nothing of jax or
of the jax package ``repro``.
"""
from __future__ import annotations

import copy
import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(REPO, "src")

HBM_BYTES_PER_S = 3.35e12     # H100 SXM HBM3 (NVIDIA data sheet)
FP32_FLOPS = 67e12            # H100 SXM float32 outside the tensor cores
SERVE_SLOTS = 65536
D_OBS, D_Z, WIDTH = 1, 16, 32  # benchmarks/table1_ou.py widths
RAGGED = 1_000_003
TRAIN_ELEMS = 256 * D_Z        # one Table-1 training batch (benchmarks/table1_ou.py)
CHECK_EPOCHS = 3              # Table-1 epochs held against the plain path


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


def kernel_phase(torch, timer):
    """Phase 3: each kernel against its plain twin; returns per-kernel stats."""
    from repro_torch.core.williamson import EES25_2N
    from repro_torch.kernels.sde_step import ref as sref
    from repro_torch.kernels.sde_step.sde_step import (axpy_chain, increment_diag,
                                                       ws_stage_diag, ws_stage_diag_bwd)
    from repro_torch.kernels.williamson2n.ref import williamson2n_ref
    from repro_torch.kernels.williamson2n.williamson2n import williamson2n

    a, b, h = EES25_2N.A[1], EES25_2N.B[1], 0.25
    gen = torch.Generator(device="cuda").manual_seed(1234)
    served = SERVE_SLOTS * D_Z
    shapes = (("served", served, 0), ("ragged", RAGGED, 0),
              ("unaligned", RAGGED, 1))
    # The training kernels are held bitwise (tolerance 0) at the Table-1
    # batch too; the one PyTorch call that computes the s=1 axpy chain
    # (torch.add with alpha) is timed beside it, and used nowhere in the port.
    train_shapes = (("training", TRAIN_ELEMS, 0),) + shapes
    specs = {
        "ws_stage_diag": dict(
            n_in=5, symbol="ws_stage_diag_kernel", shapes=shapes, exact=False,
            kernel=lambda x: ws_stage_diag(*x, h, a=a, b=b),
            plain=lambda x: sref.ws_stage_diag_ref(*x, h, a, b),
            bytes_per_elem=7, ops_per_elem=6, library=None),
        "williamson2n": dict(
            n_in=3, symbol="williamson2n_kernel", shapes=shapes, exact=False,
            kernel=lambda x: williamson2n(*x, a=a, b=b),
            plain=lambda x: williamson2n_ref(*x, a, b),
            bytes_per_elem=5, ops_per_elem=4, library=None),
        "ws_stage_diag_bwd": dict(
            n_in=4, symbol="ws_stage_diag_bwd_kernel", shapes=train_shapes,
            exact=True, kernel=lambda x: ws_stage_diag_bwd(*x, h, a=a, b=b),
            plain=lambda x: sref.ws_stage_diag_bwd_ref(*x, h, a, b),
            bytes_per_elem=8, ops_per_elem=6, library=None),
        "increment_diag": dict(
            n_in=3, symbol="increment_diag_kernel", shapes=train_shapes,
            exact=True, kernel=lambda x: (increment_diag(*x, h),),
            plain=lambda x: (sref.increment_diag_ref(*x, h),),
            bytes_per_elem=4, ops_per_elem=3, library=None),
        "axpy_chain": dict(
            n_in=2, symbol="axpy_chain_kernel", shapes=train_shapes,
            exact=True, kernel=lambda x: (axpy_chain(x[0], x[1:], [0.5]),),
            plain=lambda x: (sref.axpy_chain_ref(x[0], x[1:], [0.5]),),
            bytes_per_elem=3, ops_per_elem=2,
            library=lambda x: torch.add(x[0], x[1], alpha=0.5)),
    }
    stats = {}
    for name, spec in specs.items():
        worst = {}
        for dtype in (torch.float32, torch.float64):
            tol = 0.0 if spec["exact"] else 4 * torch.finfo(dtype).eps
            for label, n, offset in spec["shapes"]:
                xs = [torch.randn(n + offset, generator=gen, device="cuda",
                                  dtype=dtype)[offset:]
                      for _ in range(spec["n_in"])]
                got = spec["kernel"](xs)
                want = spec["plain"](xs)
                torch.cuda.synchronize()
                abs_err, rel_err, same = compare(torch, got, want)
                scale = max(1.0, max(w.abs().max().item() for w in want))
                print(f"  {name} {str(dtype)[6:]} {label} n={n}: max_abs_err="
                      f"{abs_err:.3e} max_rel_err={rel_err:.3e} bitwise={same}"
                      f" (tolerance {tol:.1e} x max|out|)", flush=True)
                check(abs_err <= tol * scale,
                      f"{name} {dtype} {label} disagrees with its plain twin")
                worst[(dtype, label)] = abs_err
        xs = [torch.randn(served, generator=gen, device="cuda")
              for _ in range(spec["n_in"])]
        ms = timer.ms(lambda: spec["kernel"](xs), spec["symbol"])
        ms_warm = timer.ms(lambda: spec["kernel"](xs), spec["symbol"],
                           flush=False)
        plain_ms = timer.ms(lambda: spec["plain"](xs))
        plain_warm = timer.ms(lambda: spec["plain"](xs), flush=False)
        library_ms = None
        if spec["library"] is not None:
            library_ms = timer.ms(lambda: spec["library"](xs))
            print(f"  {name}: the one PyTorch call computing it "
                  f"(torch.add(y, inc, alpha=c)) {library_ms * 1e3:.2f} us with "
                  f"L2 flushed", flush=True)
        bytes_moved = spec["bytes_per_elem"] * served * 4
        bound_bytes_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
        bound_ops_ms = spec["ops_per_elem"] * served / FP32_FLOPS * 1e3
        bound_ms = max(bound_bytes_ms, bound_ops_ms)
        print(f"  {name} float32 served n={served}, device time: kernel "
              f"{ms * 1e3:.2f} us with L2 flushed ({ms_warm * 1e3:.2f} us warm),"
              f" plain twin {plain_ms * 1e3:.2f} us ({plain_warm * 1e3:.2f} us "
              f"warm); bound {bound_ms * 1e3:.2f} us ({bytes_moved} B at "
              f"3.35 TB/s; ops bound {bound_ops_ms * 1e3:.3f} us); "
              f"{bound_ms / ms:.0%} of the HBM bound", flush=True)
        stats[name] = dict(max_abs_err=max(worst.values()),
                           ms=ms, ms_warm=ms_warm, plain_ms=plain_ms,
                           bound_ms=bound_ms, library_ms=library_ms,
                           bound_by="bytes" if bound_bytes_ms >= bound_ops_ms
                           else "operations")
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
    from repro_torch.kernels import KERNELS
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
    print(f"  torch {torch.__version__} (CUDA {torch.version.cuda}) on "
          f"{torch.cuda.get_device_name(0)}; TF32 off: "
          f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}", flush=True)

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

    tpu = "src/repro/kernels/sde_step/sde_step.py"
    sources = {"ws_stage_diag": ("ws_stage_diag.cu", f"{tpu}:144"),
               "williamson2n": ("williamson2n.cu",
                                "src/repro/kernels/williamson2n/williamson2n.py:56"),
               "ws_stage_diag_bwd": ("ws_stage_diag_bwd.cu", f"{tpu}:182"),
               "increment_diag": ("increment_diag.cu", f"{tpu}:65"),
               "axpy_chain": ("axpy_chain.cu", f"{tpu}:286")}
    record = {"kernels": [
        {"name": name, "route": "cuda",
         "source": f"src/repro_torch/csrc/{sources[name][0]}",
         "replaces": sources[name][1], "launches": launches[name],
         "max_abs_err": stats[name]["max_abs_err"], "ms": stats[name]["ms"],
         "plain_ms": stats[name]["plain_ms"],
         "bound_ms": stats[name]["bound_ms"],
         "bound_by": stats[name]["bound_by"],
         "library_ms": stats[name]["library_ms"]}
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
