#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

Run from the root of a checkout, with no arguments::

    python3 chip_smoke.py

It drives the port's paths through the thirteen hand-written CUDA kernels
(and the per-path step-size entries of the seven that take a step) — an
``SDESampleEngine`` serving EES(2,5) and EES(2,7) Monte-Carlo sampling
requests of the neural Langevin SDE at its Table-1 widths (``d_obs=1,
d_z=16, width=32``) plus an ODE-mode ``sdeint``, the paper's Table-1
training run with the reversible adjoint, the serving and training of
additive- and general-noise SDEs, the LM substrate's prefill and decode of
zamba2-7b at full width, and the paper's Tables 7 and 2 and its stability
frontier, the async serving plane under faults, with warmup into a
persistent kernel cache, adaptive solves on Virtual Brownian Trees,
served and differentiated, scanned training steps captured as CUDA
graphs under the train loops, the paper's manifold experiments
(Tables 3 and 4, served manifold requests, Fig 8's SO(3) rates), and the LM
trained at full width through the attention and SSD kernels and their
backward kernels, with EES(2,5) over residual depth, the moe family and
the vision and audio frontends at full width, and the LM sharded over
DTensor meshes — and checks what comes out:

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
   beside ``torch.add``'s at 4,096; the two backward kernels against their
   twins, each run twice (bitwise-equal gradients): ``flash_attention_bwd``
   at the reference's test shapes in float32 (1e-5 of each gradient's
   max|.|) and bf16 (against the twin in float32 on the same inputs: one
   bf16 rounding, 2^-8 |want|, plus 1e-5 of max|.|), qwen3-1.7b's GQA, a
   ragged 200, d = 1 and 127, zamba2-7b's and olmo-1b's layers in bf16,
   timed at zamba2-7b's beside the twin and SDPA's backward; phase 19's
   attention shapes (qwen3-moe-30b-a3b's (1, 32, 4, 2048, 128), qwen2-vl-2b's
   (2, 12, 2, 2048, 128), hubert-xlarge's non-causal (2, 16, 16, 2048, 80))
   forward in float32 and bf16 and backward in bf16, each timed in bf16
   beside SDPA's;
   ``ssd_scan_bwd`` at the reference's shapes, the decay extremes (also
   against the float64 twin), zamba2-7b's and mamba2-130m's layers (1e-4 of
   each gradient's max|.|), timed at zamba2-7b's, with each launch apart;
   both attention kernels in bf16 at sequences past 2048 tokens
   (``FLASH_LONG_SHAPES``: zamba2-7b's head at 4096, qwen3-moe-30b-a3b's GQA
   group of 8 and hubert-xlarge's non-causal d = 80 at 8192) against their
   float32 twins one KV group at a time, each output's ratio to phase 3's
   bf16 gate printed (the tensor cores' toward-zero accumulation, ROADMAP
   C6), timed beside SDPA's forward and backward;
4. serving requests A-D (A and B share a padded bucket; D is A's seed on the
   plain path) through captured tick graphs (one per signature and per
   bucket and live-step count, every tick of the drain a replay), with
   shapes, finiteness, A against D, A against a CPU run of the plain path,
   paths/s, dispatch counts, the graphs' count, capture seconds, replays
   and pool MiB, a profile of one replayed dispatch and a replayed dispatch
   under ``set_sync_debug_mode("error")``; then one tick of each captured
   key (A/B's bucket at 8 and 6 live steps, C's signature with
   ``save_every=4``, D's bucket) replayed against the eager
   ``sdeint_ticks`` on the same keys, bitwise;
5. an ODE-mode ``sdeint`` through the ``williamson2n`` kernel against the
   plain path;
6. the serving path's launch counts, the replayed ones among them;
7. Table 1 on the card: the four ``:use_kernels=True`` solvers trained for
   the reference's 60 epochs at 256 paths, after their first epochs are
   held against the plain path on the card and on the CPU; the
   ``axpy_chain`` launches by chain length; one step of each under
   ``torch.cuda.set_sync_debug_mode("error")``;
8. one EES(2,5) training step at 65,536 paths under the reversible, the
   full and the recursive adjoint (checkpointed chunks of 2 and 4 steps),
   8 and 64 steps: peak device memory (at 64 steps reversible < recursive <
   full), one recursive step bitwise equal to one full step, and the
   profile of one reversible step;
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
   greedy, ``slots=8, max_len=32``, its ``serve_step`` captured into a CUDA
   graph: tokens/s, ticks, finite logits, capture seconds, the same tokens
   from a drain whose step is the eager ``make_serve_step(cfg)`` and from a
   second graphed drain on a new engine, ms a tick graphed and eager; one
   decode step's host wall, device time and launches, eager and replayed;
13. the paper's Euclidean experiments at the reference's sizes
   (``repro_torch.benchmarks.table7_gbm``, ``table2_vol``,
   ``bench_stability``): (a) Table 7's four solvers through the kernels,
   bitwise equal to the plain path on the card and within 1e-4 of max |y_T|
   of the CPU's plain path (where finite; non-finite on both alike),
   EES(2,5) stable and Reversible Heun not; (b) Table 2's four solvers
   under the reversible adjoint, kernels against plain (loss and each
   gradient leaf within 1e-5 of its own max), ms per forward + backward
   and the signature MMD, one EES(2,5) call's device busy share, then
   EES(2,5) under the full, recursive and reversible adjoints: the
   recursive gradients bitwise equal to the full ones, the reversible
   ones within 1e-4 of each leaf's max, peak memory
   reversible < recursive < full (with per-step noise; the bulk draw's
   peak is shared by the two) and the ms of each; (c) the stability sweep
   in full on the plain specs and EES(2,5) / EES(2,7) through the kernels
   (frontiers identical), each frontier beside the reference's
   ``BENCH_stability.json`` (differences printed) and the reference's gate;
14. the async serving plane on phase 4's model and requests A-C
   (``AsyncSDESampleEngine``, 65,536 slots, 2 ticks a dispatch, bucketing):
   (a) two rounds, the model's parameters requiring gradients, bitwise equal
   to phase 4's sync drain, through ``ws_stage_diag``, with async and sync
   paths/s, the second round's host time by layer, no host sync inside a
   steady-state dispatch under ``set_sync_debug_mode("warn")``, first
   dispatches (and every tick-graph capture) in worker threads, every
   eager launch and every replay on the executor's stream, every tick a
   replay, and no result carrying an autograd graph; (b) seeded NaN faults (rate 0.3,
   seed 0, plus one targeted cell of A): every request completes, A retries,
   B and C bitwise (a); (c) one injected crash: one supervised restart,
   bitwise (a); (d) ``warmup`` of A-C's signatures in a fresh process with a
   temporary ``compile_cache_dir`` builds ``ws_stage_diag`` there, and a
   second process on that directory runs no ``nvcc`` but captures its
   tick graphs again, each one's seconds printed;
15. adaptive solves on Virtual Brownian Trees, on phase 4's model: (a)
   request O (``ees25:adaptive,use_kernels=True``, t1 = 2, a 256-trial
   budget, 65,536 paths, rtol 1e-3, ``save_at`` 0.5/1/1.5/2) and P (O's
   plain spec) through the sync engine at 65,536 slots, bitwise equal
   (y_final, ys, t_final, counts), every path at t1, O only through the
   per-path ``ws_stage_diag`` entry; paths/s, trials, host syncs, mean
   counts; one short tick profiled (device ms a trial, against O's host
   ms a trial); O's first tick (65,536 paths) again through the async
   engine, bitwise to the sync drain's; (b) float64, 256 of O's paths: the controller on the card and on
   the CPU, beside the card's own run with h0 one ulp up, whose per-path
   spread sigma sets the gate: the means of the counts, of y_final and of
   its squared deviation within 6 sigma / sqrt(256) of the CPU's, their
   per-path spread within 2 sigma; one realized grid solved on both,
   within 1e-9 relative; bounded == unbounded on the card; (c) one grid
   realized at 4,096 paths, reversible-adjoint gradients over it with the
   kernels (the per-path ``ws_stage_diag_bwd`` entry) bitwise to plain,
   against the full adjoint's; the three adjoints' peak memory at 65,536
   paths over one realized grid with bulk increments, and the reversible
   adjoint's with per-step increments; (d) the other five per-path entries
   on public paths: ``heun:adaptive`` and ``milstein:adaptive`` requests on
   the Langevin model (increment_diag and axpy_chain), Reversible Heun and
   MCF over one realized grid, bitwise to their plain specs;
   adaptive ``ees25`` and ``heun`` solves on phase 9's general term (the
   general pair; the controller turns the kernels' other summation order
   into other accept sequences on some paths, so the two are held as
   Monte-Carlo estimators: the means of the counts and of y_final within 6
   standard errors) and the two over one realized grid (1e-5); EES(2,5) and Reversible Heun on the additive term over one
   realized grid under the full adjoint with bulk increments (the
   prediffused pair), bitwise with gradients.  Phase 3 also holds the seven
   per-path entries bitwise to their twins (h varying per row; d = 16, d = 3
   whose float32 packs straddle paths, unaligned; the general pair at m = 4
   and 128, each route checked) and times them beside the scalar entries;
16. the training pipeline on the Table-1 model (d_z = 16, width 32, 256
   paths, float32): (a) the four Table-1 specs under the reversible adjoint
   and EES(2,5) under the full and recursive ones, 2 chunks of
   ``make_scanned_step(step, 8)`` — each one CUDA graph, captured once and
   replayed — bitwise equal to 16 sequential steps (parameters, optimizer
   state, losses, skips, counters); ms a step sequential against a replay,
   the capture's seconds, EES(2,5)'s device busy share of each; a
   replay-only call launches nothing from Python while the replayed count
   rises by the graph's record; an adaptive step stays eager
   (``graphed == False``); (b) one EES(2,5) step at 65,536 paths x 8 steps,
   8 steps graphed bitwise to 8 eager ones, and the peak memory of each;
   (c) ``microbatches = 4`` against 1 in float64 within the reference's
   tolerance, and the microbatched step graphed bitwise; (d)
   ``resilient_train_loop`` with NaN losses at fixed steps (K = 4, graphed,
   checkpoints in a temporary directory): skips, rollbacks and goodput equal
   the CPU's and the stepwise loop's; fault-free, chunked bitwise to
   stepwise; (e) ``train_loop`` with K = 4 bitwise to K = 1, with
   ceil(steps / K) dispatches;
17. the manifold experiments, float32 (``repro_torch.benchmarks.
   table3_kuramoto``, ``table4_sphere``, ``fig_convergence``), through no
   kernel (none lies on the manifold path; the phase checks that none
   launches): (a) Table 3 at its sizes — the 15 epochs of each case on
   the card (energy scores, ms a step), their first 2 against the CPU's
   from the same key (losses within 1e-4), CF-EES(2,5) reversible gradients within 1e-4 of the full
   adjoint's, and Fig 5b's peak memory at 32 / 128 / 512 steps with
   per-step increments (gated: the reversible growth below a tenth of the
   full one's, full at least 8x, recursive below full) and at 32 / 512
   with bulk ones (printed); (b) Table 4 likewise (25 epochs, accuracies, Fig 6: reversible
   against full); (c) requests Q (``cfees25``) and R (``cfees27``), 131,072
   paths each, on ``sphere_nsde_term(8)`` at 65,536 slots (unit norm within
   1e-5, 256 of Q's paths against the CPU within 1e-4, paths/s, one tick
   dispatched under ``set_sync_debug_mode("error")``), one torus
   request inside [-pi, pi], and ``"geo-em"`` refused by phase 4's Langevin
   engine with the reference's message; (d) Fig 8's SO(3) CF-EES(2,5) rates
   in float64, the card's errors within 1e-9 of the CPU's, the reference
   solution within 1e-12 of SO(3).  The memory curves (three processes,
   each reading its own allocator's peak) and the CPU's side of the checks
   (one process) run beside the card's training and serving, and are
   stopped with the phase;
18. LM training at full width: (a) zamba2-7b cut to 12 of its 81 layers
   (the shared block at layers 0 and 6), bf16, B = 2 x 2048, each layer
   rematerialised: four AdamW steps of ``train_loop``'s default step on
   the synthetic token stream, then four with two microbatches; losses
   finite, the four LM kernels' launches exact, ms a step, tokens/s, peak
   memory and the device's busy share of one step; one step run twice from
   one state, bitwise; at 2 layers, a run interrupted at step 2 and resumed
   from its checkpoint (bf16 leaves), bitwise an unbroken run; (b) the same
   width at 12 layers in float32, B = 1 x 512: the loss and every gradient
   leaf on the kernel path against the plain path; (c) EES(2,5) over
   olmo-1b's residual depth at full width, float32, B = 4 x 512: the
   reversible adjoint's gradients through the kernels against the plain
   path and against the full adjoint, and peak memory above the parameters
   and gradients at 4, 8 and 16 layers (reversible flat, under 10% growth;
   full at least 3x); (d) ``python -m repro_torch.launch.train --arch
   zamba2-7b --steps 4`` as a subprocess;
19. the moe family and the frontends in bf16 at full width: (a)
   olmoe-1b-7b at its 16 layers, (b) qwen3-moe-30b-a3b at 12 of 48 (the
   full depth's 61 GB of weights leave no room): a 2 x 2048 prefill, an
   8-request decode ``Engine`` drain (twice, the same tokens), one layer's
   ``moe_block`` profiled, four AdamW steps of ``train_loop``'s default step
   at 4 (olmoe) and 2 (qwen3-moe) layers, one step timed, profiled and run
   twice from one state (bitwise); (c) qwen2-vl-2b (28 layers, 256 vision
   tokens) and (d) hubert-xlarge (48 layers, frames, non-causal, the
   ``Engine`` refusing it): a 2 x 2048 forward and training steps; each
   with ms, tokens/s, peak memory, the device's busy share and the attention
   launches by route (all ``wgmma``); before each, in float32 at 2 layers,
   the kernel path against the plain path (1e-4 of max|logit| over the
   real vocab) and decode
   against the forward (atol 2e-5), moe at dropless capacity, on the tokens
   before a sequence's first token whose expert set differs (at most 1% of
   tokens may);
20. mesh data parallelism (``repro_torch.launch.mesh``): (a) requests A-C
   through ``SDESampleEngine`` with its slots sharded on
   ``make_sample_mesh(1)`` over a world of one NCCL rank, its ticks
   replayed from tick graphs that hold the all-gather, bitwise phase 4's
   drain, paths/s beside phase 4's, ``ws_stage_diag`` launched; (b) the
   Table-1 EES(2,5) step (kernels, reversible adjoint) for 3 AdamW steps on
   ``make_train_mesh(1)``, bitwise the steps without a mesh, ms a step,
   ``ws_stage_diag_bwd`` launched, and the mesh step captured by
   ``make_scanned_step`` into a CUDA graph, bitwise the sequential steps;
   (c) two processes on the one card over gloo's CUDA collectives (NCCL
   refuses two ranks on one device): request A sharded (held to one rank's
   drain; the gloo executors run eagerly) and one Table-1 step (the
   gradient within the reorder bound of one device's);
21. the LM's tensor, expert and sequence parallelism on DTensor: (a)
   zamba2-7b at full width, bf16, 12 layers, B = 2 x 2048, remat: two AdamW
   steps of ``make_train_step`` with every parameter a DTensor on a (1, 1)
   ``("data", "model")`` mesh of one NCCL rank under
   ``ShardingPolicy(("data",), "model")``, step by step beside the steps
   without a mesh: losses, every gradient and every parameter bitwise, the
   four LM kernels' launches exact and on the ``wgmma`` route, ms a step of
   both; (b) a (1, 2) mesh as two gloo processes on the card: zamba2-7b in
   float32 at 2 layers (logits within 1e-5 of max|logit| of the one-rank
   run, gradients within 18b's limit), bf16 at 4 layers (one step, the
   loss within 2e-2), four decode ticks with ``cache_pspecs``-pinned
   caches (the same greedy tokens), olmoe-1b-7b's prefill at 2 layers with
   32 + 32 experts (float32: at most 1% of tokens flip an expert set, the
   logits before a flip within 1e-5; bf16: at most 20% flip, the logits
   before one within 2e-2, and bitwise a one-rank witness whose attention
   output products are split and summed in bf16 as the mesh sums them),
   every logit gate over the real vocab (the pad columns hold -1e9); each
   rank's kernels on its half of the heads and experts, on their routes;
22. the dry run against the card: (a) 18a's step (zamba2-7b, 12 layers,
   bf16, 2 x 2048, remat, AdamW) dry-run on fake tensors over a fake world
   of one rank (``launch/dryrun.py``, in its own process): its FLOPs, peak
   bytes and roofline terms; (b) the same step built by ``build_cell`` with
   real weights on a (1, 1) mesh of one NCCL rank, on the plain path:
   ``FlopCounterMode``'s FLOPs equal the prediction within 1e-6, the
   predicted peak within 10% of ``max_memory_allocated`` less what was
   allocated before the step's weights, the roofline
   bound over the device time printed; the kernel path's peak and device
   time beside them; (c) ``python -m repro_torch.launch.dryrun`` on
   qwen3-1.7b ``train_4k`` (256 fake ranks) and zamba2-7b ``decode_32k``
   (512), each ending ``[ok]``; (a) and (c) run on the host beside (b).

Each phase prints its seconds.  The launch counts are zeroed just before
each path (phases 4-5, the 60-epoch runs of phase 7, phase 9's drain and its
m = 128 request, phase 10's runs, phase 11's counted prefill, the kernel
runs of 13a-13c and of 14a-14c, request O of 15a, 15c's kernel gradient,
phase 16; phase 17, which must launch none; phase 18a's first run; the
paths of 15d; phase 19's counted forwards and training steps; 20a's drain
and 20b's mesh steps; 21a's mesh steps) and
read just after; a kernel of the path with no launch there fails the run.  The second-to-last
line is the ``{"kernels": [...]}`` record (``launches`` counts the path each
kernel was first held to, as in earlier runs — for the per-path entries
``ws_stage_diag_rows`` and ``ws_stage_diag_bwd_rows``, request O and 15c's
kernel gradient; the general-noise kernels add ``launches_by_route``, the
Euclidean-path kernels ``launches_phase_13``, ``ws_stage_diag``
``launches_phase_14``, the four kernels of phase 16 ``launches_phase_16``
(eager launches plus each graph's captured launches times its replays) and
``replayed_phase_16``, ``flash_attention`` and ``ssd_scan``
``launches_phase_18``, ``flash_attention`` and ``flash_attention_bwd``
``launches_phase_19``, ``ws_stage_diag`` and ``ws_stage_diag_bwd``
``launches_phase_20``, the four LM kernels ``launches_phase_21``,
``axpy_chain`` ``launches_phase_15d``; the five
other per-path entries count 15d's paths; the backward kernels count phase
18a's run, and name the reference function whose ``jax.grad`` they
compute) and the last line
``{"ok": true, "device": {...}}``.  Any failed phase exits non-zero; with no
CUDA device, or without the ``src/repro_torch`` package beside this script,
it exits non-zero before printing any result.  It imports nothing of jax or
of the jax package ``repro``.
"""
from __future__ import annotations

import copy
import dataclasses
import json
import os
import re
import subprocess
import sys
import tempfile
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

    def kernels_us(self, fn, reps: int = 30, flush: bool = True, warm: bool = True):
        """{kernel name: (total device us, launches)} over ``reps`` calls,
        after one unprofiled call when ``warm``."""
        torch = self.torch
        from torch.profiler import ProfilerActivity, profile

        if warm:
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
# Phase 19's attention layers at 2048 tokens: qwen3-moe-30b-a3b's GQA group
# 8, qwen2-vl-2b's group 6, hubert-xlarge's non-causal head dim 80.
FLASH_P19_SHAPES = ((1, 32, 4, 2048, 128, True, None), (2, 12, 2, 2048, 128, True, None),
                    (2, 16, 16, 2048, 80, False, None))
FLASH_LM_SHAPES = ((2, 32, 32, 2048, 112, True, None), (1, 16, 8, 2048, 128, True, None),
                   (2, 4, 2, 200, 112, True, None),
                   (2, 4, 2, 200, 112, False, None)) + FLASH_P19_SHAPES
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
            own = ((dtype == torch.float32 and shape in FLASH_LM_SHAPES[:2])
                   or shape in FLASH_P19_SHAPES)
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
    # phase 19's shapes in bf16 on the wgmma route, beside SDPA
    for shape in FLASH_P19_SHAPES:
        b, hq, hkv, s, d, causal, _ = shape
        q, k, v = _flash_inputs(torch, gen_lm32, shape, torch.bfloat16)
        # QK^T and PV, 2 flops a MAC; causal: row t attends to t + 1 keys
        ops = 4 * b * hq * d * s * ((s + 1) / 2 if causal else s)
        _timed_row(
            "flash_attention", f"bf16 wgmma route (b,hq,hkv,s,d)={shape[:5]} "
            f"causal={causal}", timer,
            lambda: flash_attention(q, k, v, causal=causal),
            lambda: attention_ref(q, k, v, causal=causal),
            (f"scaled_dot_product_attention(is_causal={causal}, enable_gqa=True)",
             lambda: sdpa(q, k, v, is_causal=causal, enable_gqa=True)),
            "flash_attention_kernel", q.element_size() * (2 * q.numel() + 2 * k.numel()),
            ops, BF16_FLOPS, "bf16 tensor-core", worst)
        del q, k, v

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


# The backward kernels' cases (b, hq, hkv, s, d, causal, sm_scale): the
# reference's test shapes (in float32 and bf16), qwen3-1.7b's GQA, a ragged
# 200, d = 1 and 127, then zamba2-7b's and olmo-1b's layers in bf16 (the
# first of those is timed).
FLASH_BWD_SHAPES = FLASH_REF_SHAPES + ((1, 16, 8, 2048, 128, True, None),
                                       (2, 4, 2, 200, 112, True, None),
                                       (2, 4, 2, 200, 112, False, None),
                                       (1, 4, 2, 130, 1, True, None),
                                       (2, 4, 2, 129, 127, False, None))
FLASH_BWD_LM_SHAPES = ((2, 32, 32, 2048, 112, True, None),
                       (4, 16, 16, 2048, 128, True, None)) + FLASH_P19_SHAPES
FLASH_BWD_F32_REL = 1e-5   # of each gradient's max|.|, against the float32 twin
SSD_BWD_REL = 1e-4         # of each gradient's max|.|, against the float32 twin


def _check_deterministic(torch, name, label, first, again):
    check(all(torch.equal(a, b) for a, b in zip(first, again)),
          f"{name} {label}: two runs on the same inputs differ")


def lm_bwd_kernel_phase(torch, timer):
    """Phase 3, the backward kernels: ``flash_attention_bwd`` and
    ``ssd_scan_bwd`` against their plain twins (``attention_bwd_ref``,
    ``ssd_bwd_ref``), twice each (bitwise-equal runs), then timed at the LM
    path's shapes beside the twins and, for attention, SDPA's backward;
    returns their stats."""
    from repro_torch.kernels.flash_attention.flash_attention import (BWD_ROUTE_LAUNCHES,
                                                                     bwd_route,
                                                                     flash_attention,
                                                                     flash_attention_bwd)
    from repro_torch.kernels.flash_attention.ref import attention_bwd_ref
    from repro_torch.kernels.ssd_scan.ref import ssd_bwd_ref
    from repro_torch.kernels.ssd_scan.ssd_scan import ssd_scan, ssd_scan_bwd
    from torch.nn.functional import scaled_dot_product_attention as sdpa

    gen = torch.Generator(device="cuda").manual_seed(5432)
    # phase 19's shapes draw from their own generator, so every other case
    # keeps its inputs
    gen19 = torch.Generator(device="cuda").manual_seed(5433)
    stats, worst = {}, 0.0
    cases = ([(shape, dt) for shape in FLASH_BWD_SHAPES
              for dt in (torch.float32, torch.bfloat16)]
             + [(shape, torch.bfloat16) for shape in FLASH_BWD_LM_SHAPES])
    for shape, dtype in cases:
        causal, scale = shape[5], shape[6]
        g = gen19 if shape in FLASH_P19_SHAPES else gen
        q, k, v = _flash_inputs(torch, g, shape, dtype)
        do = torch.randn(q.shape, generator=g, device="cuda").to(dtype)
        out = flash_attention(q, k, v, causal=causal, sm_scale=scale)
        path = bwd_route(dtype, shape[4])
        before = BWD_ROUTE_LAUNCHES[path]
        got = flash_attention_bwd(q, k, v, out, do, causal=causal, sm_scale=scale)
        again = flash_attention_bwd(q, k, v, out, do, causal=causal, sm_scale=scale)
        check(BWD_ROUTE_LAUNCHES[path] == before + 2,
              f"flash_attention_bwd {shape} {dtype}: not counted on the {path} route")
        check(path == ("wgmma" if dtype == torch.bfloat16 and shape[4] % 8 == 0 else "simt"),
              f"flash_attention_bwd {shape} {dtype} took the {path} route")
        # the twin in float32 on the same inputs (bf16 ones widened exactly)
        want = attention_bwd_ref(*(t.float() for t in (q, k, v, out, do)), causal=causal,
                                 sm_scale=scale)
        torch.cuda.synchronize()
        _check_deterministic(torch, "flash_attention_bwd", str(shape), got, again)
        errs, ok = [], True
        for g, w in zip(got, want):
            check(g.dtype == dtype and g.shape == w.shape and bool(torch.isfinite(g).all()),
                  f"flash_attention_bwd {shape} {dtype}: output {g.dtype} {tuple(g.shape)}")
            top = w.abs().max().item()
            diff = (g.float() - w).abs()
            errs.append(diff.max().item() / top)
            if dtype == torch.float32:
                ok = ok and errs[-1] <= FLASH_BWD_F32_REL
            else:
                # the kernel rounds its float32 sums to bf16: half a bf16 ulp,
                # at most 2^-8 |want|, beyond float32's order of summation
                ok = ok and bool((diff <= 2.0 ** -8 * w.abs() + 1e-5 * top).all())
        worst = max(worst, max(e * w.abs().max().item() for e, w in zip(errs, want)))
        lim = (f"{FLASH_BWD_F32_REL:g} of max|.|" if dtype == torch.float32 else
               "2^-8 |want| + 1e-5 max|.| elementwise")
        print(f"  flash_attention_bwd {str(dtype)[6:]} (b,hq,hkv,s,d)={shape[:5]} "
              f"causal={causal} sm_scale={scale}, route {path}: dq, dk, dv vs the float32 twin "
              f"{', '.join(f'{e:.3e}' for e in errs)} of max|.| (limit {lim}); two runs "
              f"bitwise equal", flush=True)
        check(ok, f"flash_attention_bwd {shape} {dtype} disagrees with its twin")
        del q, k, v, do, out, got, again, want
    print(f"  flash_attention_bwd calls by route over the cases: {dict(BWD_ROUTE_LAUNCHES)}",
          flush=True)
    torch.cuda.empty_cache()
    shape = FLASH_BWD_LM_SHAPES[0]
    b, hq, hkv, s, d, _, _ = shape
    q, k, v = _flash_inputs(torch, gen, shape, torch.bfloat16)
    do = torch.randn(q.shape, generator=gen, device="cuda").to(torch.bfloat16)
    out = flash_attention(q, k, v, causal=True)
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    lib_out = sdpa(*leaves, is_causal=True, enable_gqa=True)
    library = lambda: torch.autograd.grad(lib_out, leaves, do, retain_graph=True)  # noqa: E731
    fwd_ops = 4 * b * hq * d * s * (s + 1) / 2  # causal: QK^T and PV, 2 flops a MAC
    stats["flash_attention_bwd"] = _timed_row(
        "flash_attention_bwd", f"bf16 (b,hq,hkv,s,d)={shape[:5]} causal", timer,
        lambda: flash_attention_bwd(q, k, v, out, do, causal=True),
        lambda: attention_bwd_ref(q, k, v, out, do, causal=True),
        ("autograd.grad through scaled_dot_product_attention(is_causal=True, "
         "enable_gqa=True), its backward alone", library),
        "flash_attention_bwd", q.element_size() * (4 * q.numel() + 4 * k.numel()),
        2.5 * fwd_ops, BF16_FLOPS, "bf16 tensor-core (2.5x the forward's products)", worst)
    print(f"  (the wgmma route does 11 products of the forward's size, S three times, dP "
          f"twice, dV, dK and dQ two passes each for the bf16 hi + lo split, at 128/{d} of "
          f"the head dim: {11 * fwd_ops / 2 * 128 / d / BF16_FLOPS * 1e6:.0f} us of its own "
          f"products at the bf16 rate)", flush=True)
    check(bwd_route(torch.bfloat16, d) == "wgmma", "zamba2-7b's backward is not on wgmma")
    for name, fn in (("stats", "flash_attention_bwd_stats"),
                     ("dkdv", "flash_attention_bwd_dkdv"), ("dq", "flash_attention_bwd_dq")):
        ms = timer.ms(lambda: flash_attention_bwd(q, k, v, out, do, causal=True), fn, reps=5)
        print(f"  flash_attention_bwd launch {name} (wgmma): {ms * 1e3:.2f} us with L2 "
              f"flushed", flush=True)
    del q, k, v, do, out, leaves, lib_out
    torch.cuda.empty_cache()
    # phase 19's shapes, beside SDPA's backward
    for shape in FLASH_P19_SHAPES:
        b, hq, hkv, s, d, causal, _ = shape
        q, k, v = _flash_inputs(torch, gen19, shape, torch.bfloat16)
        do = torch.randn(q.shape, generator=gen19, device="cuda").to(torch.bfloat16)
        out = flash_attention(q, k, v, causal=causal)
        leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
        lib_out = sdpa(*leaves, is_causal=causal, enable_gqa=True)
        fwd_ops = 4 * b * hq * d * s * ((s + 1) / 2 if causal else s)
        _timed_row(
            "flash_attention_bwd", f"bf16 (b,hq,hkv,s,d)={shape[:5]} causal={causal}",
            timer, lambda: flash_attention_bwd(q, k, v, out, do, causal=causal),
            lambda: attention_bwd_ref(q, k, v, out, do, causal=causal),
            (f"autograd.grad through scaled_dot_product_attention(is_causal={causal}, "
             "enable_gqa=True), its backward alone",
             lambda: torch.autograd.grad(lib_out, leaves, do, retain_graph=True)),
            "flash_attention_bwd", q.element_size() * (4 * q.numel() + 4 * k.numel()),
            2.5 * fwd_ops, BF16_FLOPS, "bf16 tensor-core (2.5x the forward's products)",
            worst)
        del q, k, v, do, out, leaves, lib_out
    torch.cuda.empty_cache()

    worst = 0.0
    for shape in SSD_REF_SHAPES + ("extremes",) + SSD_LM_SHAPES:
        if shape == "extremes":  # the reference's decay extremes (dt 5, A -8)
            x, _, _, B, C = _ssd_inputs(torch, gen, (1, 128, 2, 8, 16, 64))
            xs = (x, torch.full((1, 128, 2), 5.0, device="cuda"),
                  torch.tensor([-8.0, -0.001], device="cuda"), B, C)
            chunk, label = 64, "decay extremes (dt=5, A=(-8, -0.001))"
        else:
            xs, chunk = _ssd_inputs(torch, gen, shape), shape[5]
            label = f"(b,l,h,dh,ds,chunk)={shape}"
        dy = torch.randn(xs[0].shape, generator=gen, device="cuda")
        got = ssd_scan_bwd(*xs, dy, chunk=chunk)
        again = ssd_scan_bwd(*xs, dy, chunk=chunk)
        want = ssd_bwd_ref(*xs, dy, chunk=chunk)
        torch.cuda.synchronize()
        _check_deterministic(torch, "ssd_scan_bwd", label, got, again)
        errs = []
        for g, w in zip(got, want):
            check(bool(torch.isfinite(g).all()) and g.shape == w.shape,
                  f"ssd_scan_bwd {label}: non-finite or misshapen gradient")
            errs.append((g - w).abs().max().item() / w.abs().max().item())
            worst = max(worst, (g - w).abs().max().item())
        msg = (f"  ssd_scan_bwd float32 {label}: dx, ddt, dA, dB, dC vs the float32 twin "
               f"{', '.join(f'{e:.3e}' for e in errs)} of max|.| (limit {SSD_BWD_REL:g})")
        ok = max(errs) <= SSD_BWD_REL
        if shape == "extremes" or shape in SSD_REF_SHAPES[:1]:
            # and the float64 twin: the float32 twin's own distance from it
            w64 = ssd_bwd_ref(*(t.double() for t in xs), dy.double(), chunk=chunk)
            e64 = [(g.double() - w).abs().max().item() / w.abs().max().item()
                   for g, w in zip(got, w64)]
            t64 = [(t.double() - w).abs().max().item() / w.abs().max().item()
                   for t, w in zip(want, w64)]
            msg += (f"; vs the float64 twin {', '.join(f'{e:.3e}' for e in e64)} (the "
                    f"float32 twin {', '.join(f'{e:.3e}' for e in t64)}; limit "
                    f"{SSD_BWD_REL:g})")
            ok = ok and max(e64) <= SSD_BWD_REL
        print(msg + "; two runs bitwise equal", flush=True)
        check(ok, f"ssd_scan_bwd {label} disagrees with its twin")
        del xs, dy, got, again, want
    torch.cuda.empty_cache()
    b, l, h, dh, ds, L = SSD_LM_SHAPES[0]
    xs = _ssd_inputs(torch, gen, SSD_LM_SHAPES[0])
    dy = torch.randn(xs[0].shape, generator=gen, device="cuda")
    # read: x, dt, A, B, C, dy; written: dx, ddt, dA, dB, dC
    moved = 4 * (3 * xs[0].numel() + 2 * (xs[1].numel() + 2 * xs[3].numel() + h))
    nc, tri = l // L, L * (L + 1) // 2
    # multiply-adds the chunked backward needs per (b, chunk, head): C.B^T and
    # dy.u on the causal triangle, du, dC and dB (triangle and state parts),
    # the chunk states and their adjoints; 2 flops a MAC.  As for the
    # forward's row, the least
    # time for float32-exact products is three TF32 tensor-core passes (the
    # hi + lo split): the kernel runs its within-chunk products so, on TF32
    # mma.sync, and its chunk states on the float32 FMA units.
    ops = 2 * b * nc * h * (tri * ds + tri * dh + tri * dh + 2 * tri * ds
                            + 5 * L * dh * ds)
    stats["ssd_scan_bwd"] = _timed_row(
        "ssd_scan_bwd", f"float32 (b,l,h,dh,ds,chunk)={SSD_LM_SHAPES[0]}", timer,
        lambda: ssd_scan_bwd(*xs, dy, chunk=L),
        lambda: ssd_bwd_ref(*xs, dy, chunk=L), None, "ssd_bwd_kernel", moved, 3 * ops,
        TF32_FLOPS, "TF32 tensor-core (3 passes of the hi + lo split)", worst)
    print(f"  (the same work at the float32 FMA rate: {ops / FP32_FLOPS * 1e6:.2f} us; the "
          f"chunk states and adjoints alone there: "
          f"{2 * 2 * b * nc * h * L * dh * ds / FP32_FLOPS * 1e6:.2f} us)", flush=True)
    for name, fn in (("outer (states, adjoints)", "ssd_bwd_kernel_outer"),
                     ("pass (both)", "ssd_bwd_kernel_pass"),
                     ("chunk", "ssd_bwd_kernel_chunk"), ("reduce", "ssd_bwd_kernel_reduce")):
        ms = timer.ms(lambda: ssd_scan_bwd(*xs, dy, chunk=L), fn, reps=5)
        print(f"  ssd_scan_bwd launch {name}: {ms * 1e3:.2f} us with L2 flushed", flush=True)
    del xs, dy
    torch.cuda.empty_cache()
    return stats


# Sequences past 2048 tokens, bf16 on the wgmma routes (ROADMAP C6: the
# tensor cores add each wgmma k-step into a float32 accumulator rounding
# toward zero, so a long sum in one accumulator drifts): zamba2-7b's head at
# 4096 tokens, qwen3-moe-30b-a3b's GQA group of 8 and hubert-xlarge's
# non-causal d = 80 at 8192.
FLASH_LONG_SHAPES = ((1, 32, 32, 4096, 112, True, None), (1, 32, 4, 8192, 128, True, None),
                     (1, 16, 16, 8192, 80, False, None))
FLASH_LONG_REPS = 5


def _per_kv_group(torch, fn, hq, hkv, q_like, k_like):
    """``fn`` over one KV head and its group of query heads at a time (the
    twins materialise (sq, sk) float32 scores: 256 MiB a head at 8192);
    outputs concatenated on the head axis, q-shaped ones before k-shaped."""
    g = hq // hkv
    outs = [fn(*(t[:, j * g:(j + 1) * g] for t in q_like),
               *(t[:, j:j + 1] for t in k_like)) for j in range(hkv)]
    if isinstance(outs[0], torch.Tensor):
        return torch.cat(outs, dim=1)
    return tuple(torch.cat(parts, dim=1) for parts in zip(*outs))


def flash_long_phase(torch, timer):
    """Phase 3, C6: ``flash_attention`` and ``flash_attention_bwd`` in bf16
    at ``FLASH_LONG_SHAPES`` against their float32 twins (one KV group at a
    time) under phase 3's bf16 gates, each gradient's ratio to its gate
    printed; the backward twice (bitwise-equal runs); both timed beside
    SDPA's forward and backward (the twins are not timed here: whole, they
    would hold (b, hq, s, s) float32 scores, 8 GiB at 8192).  Returns the
    rows {shape: {fwd_us, sdpa_us, bwd_us, sdpa_bwd_us, ratios}}."""
    from repro_torch.kernels.flash_attention.flash_attention import (
        BWD_ROUTE_LAUNCHES, ROUTE_LAUNCHES, flash_attention, flash_attention_bwd)
    from repro_torch.kernels.flash_attention.ref import attention_bwd_ref, attention_ref
    from torch.nn.functional import scaled_dot_product_attention as sdpa

    # drawn from a generator of their own, so no earlier case changes
    gen = torch.Generator(device="cuda").manual_seed(5434)
    rows = {}
    for shape in FLASH_LONG_SHAPES:
        b, hq, hkv, s, d, causal, scale = shape
        q, k, v = _flash_inputs(torch, gen, shape, torch.bfloat16)
        do = torch.randn(q.shape, generator=gen, device="cuda").to(torch.bfloat16)
        fwd0, bwd0 = ROUTE_LAUNCHES["wgmma"], BWD_ROUTE_LAUNCHES["wgmma"]
        out = flash_attention(q, k, v, causal=causal, sm_scale=scale)
        got = flash_attention_bwd(q, k, v, out, do, causal=causal, sm_scale=scale)
        again = flash_attention_bwd(q, k, v, out, do, causal=causal, sm_scale=scale)
        check(ROUTE_LAUNCHES["wgmma"] == fwd0 + 1 and BWD_ROUTE_LAUNCHES["wgmma"] == bwd0 + 2,
              f"flash attention {shape}: not on the wgmma routes")
        want = _per_kv_group(
            torch, lambda q_, k_, v_: attention_ref(q_, k_, v_, causal=causal,
                                                    sm_scale=scale), hq, hkv, (q,), (k, v))
        torch.cuda.synchronize()
        diff = (out.float() - want.float()).abs()
        fwd_ratio = (diff / (8e-3 * want.float().abs() + 1e-3)).max().item()
        fwd_err = diff.max().item()
        del want, diff
        _check_deterministic(torch, "flash_attention_bwd", str(shape), got, again)
        del again
        # the twin in float32 on the same inputs (bf16 ones widened exactly)
        want = _per_kv_group(
            torch, lambda q_, o_, do_, k_, v_: attention_bwd_ref(
                q_, k_, v_, o_, do_, causal=causal, sm_scale=scale),
            hq, hkv, tuple(t.float() for t in (q, out, do)), (k.float(), v.float()))
        torch.cuda.synchronize()
        ratios = []
        for g_, w in zip(got, want):
            check(g_.shape == w.shape and bool(torch.isfinite(g_).all()),
                  f"flash_attention_bwd {shape}: non-finite or misshapen gradient")
            gate = 2.0 ** -8 * w.abs() + 1e-5 * w.abs().max()
            ratios.append(((g_.float() - w).abs() / gate).max().item())
        del got, want
        torch.cuda.empty_cache()
        print(f"  long sequence bf16 (b,hq,hkv,s,d)={shape[:5]} causal={causal}, wgmma "
              f"routes: forward max_abs_err={fwd_err:.3e}, |got-want| / (8e-3 |want| + "
              f"1e-3) = {fwd_ratio:.3f} of the gate (tolerance 1, and atol 3e-2); "
              f"backward dq, dk, dv |got-want| / (2^-8 |want| + 1e-5 max|want|) = "
              f"{', '.join(f'{r:.3f}' for r in ratios)} of the gate (tolerance 1); two "
              f"backward runs bitwise equal", flush=True)
        check(fwd_err <= 3e-2 and fwd_ratio <= 1.0,
              f"flash_attention {shape} misses the bf16 gate ({fwd_ratio:.3f})")
        check(max(ratios) <= 1.0,
              f"flash_attention_bwd {shape} misses the bf16 gate ({max(ratios):.3f})")
        fwd_ops = 4 * b * hq * d * s * ((s + 1) / 2 if causal else s)
        leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
        lib_out = sdpa(*leaves, is_causal=causal, enable_gqa=True)
        us = {
            "fwd_us": timer.ms(lambda: flash_attention(q, k, v, causal=causal),
                               "flash_attention_kernel", reps=FLASH_LONG_REPS) * 1e3,
            "sdpa_us": timer.ms(lambda: sdpa(q, k, v, is_causal=causal, enable_gqa=True),
                                reps=FLASH_LONG_REPS) * 1e3,
            "bwd_us": timer.ms(lambda: flash_attention_bwd(q, k, v, out, do, causal=causal),
                               "flash_attention_bwd", reps=FLASH_LONG_REPS) * 1e3,
            "sdpa_bwd_us": timer.ms(lambda: torch.autograd.grad(lib_out, leaves, do,
                                                                retain_graph=True),
                                    reps=FLASH_LONG_REPS) * 1e3}
        bound_fwd = max(fwd_ops / BF16_FLOPS,
                        q.element_size() * (2 * q.numel() + 2 * k.numel()) / HBM_BYTES_PER_S)
        bound_bwd = max(2.5 * fwd_ops / BF16_FLOPS,
                        q.element_size() * (4 * q.numel() + 4 * k.numel()) / HBM_BYTES_PER_S)
        print(f"    device time, L2 flushed, {FLASH_LONG_REPS} calls: flash_attention "
              f"{us['fwd_us']:.2f} us, scaled_dot_product_attention(is_causal={causal}, "
              f"enable_gqa=True) {us['sdpa_us']:.2f} us, bound {bound_fwd * 1e6:.2f} us "
              f"(operations); flash_attention_bwd {us['bwd_us']:.2f} us, SDPA's backward "
              f"alone {us['sdpa_bwd_us']:.2f} us, bound {bound_bwd * 1e6:.2f} us "
              f"(operations)", flush=True)
        rows[shape] = dict(us, fwd_ratio=fwd_ratio, bwd_ratios=ratios)
        del q, k, v, do, out, leaves, lib_out
        torch.cuda.empty_cache()
    return rows


# Requests A-C of phase 4: (spec, t1, n_steps, n_paths, save_every, seed);
# D is A on the plain path.
ABC = (("ees25:use_kernels=True", 2.0, 8, 2 * SERVE_SLOTS, None, 11),
       ("ees25:use_kernels=True", 1.5, 6, SERVE_SLOTS, None, 12),
       ("ees27:use_kernels=True", 2.0, 16, SERVE_SLOTS, 4, 13))
D_REQUEST = ("ees25", 2.0, 8, 2 * SERVE_SLOTS, None, 11)


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
    print(f"  one bucketed tick ({SERVE_SLOTS} paths x 8 steps), a graph replay: host "
          f"wall {wall_ms:.3f} ms, device kernel time {dev_ms:.3f} ms over "
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
        check(engine.executor.graphed and (bucket, 8, SERVE_SLOTS) in engine.executor._graphs,
              "the warm-up drain captured no tick graph of A's bucket")
        tick_keys = path_keys(PRNGKey(7, device="cuda"), SERVE_SLOTS)[None]
        tick_breakdown(torch, timer, engine, tick_keys, bucket)

        # Dispatch and key packing must not wait on the device, or double
        # buffering cannot overlap planning with integration: a replay,
        # after the capture.
        n_graphs, n_replays = len(engine.executor._graphs), engine.executor.n_replays
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            engine.executor.dispatch(bucket, tick_keys, (8,))
            path_keys(PRNGKey(123, device="cuda"), SERVE_SLOTS)
        except RuntimeError as exc:
            fail(f"dispatch synchronized with the host: {exc}")
        finally:
            torch.cuda.set_sync_debug_mode("default")
        check(len(engine.executor._graphs) == n_graphs
              and engine.executor.n_replays == n_replays + 1,
              "the sync-checked dispatch was not a replay")
        print("  a bucketed dispatch (a graph replay) and a request's key packing ran "
              "with torch.cuda.set_sync_debug_mode('error'): no host sync", flush=True)

        host = {"dispatch": 0.0, "deliver": 0.0}

        def timed(name, fn):
            def wrapper(*a, **k):
                start = time.perf_counter()
                try:
                    return fn(*a, **k)
                finally:
                    host[name] += time.perf_counter() - start
            return wrapper

        # A-D's keys captured ahead of traffic, so the timed drain replays
        start = time.perf_counter()
        fresh = engine.warmup([dict(solver=s, t1=t1, n_steps=n, save_every=se)
                               for s, t1, n, _, se, _ in ABC + (D_REQUEST,)])
        print(f"  warmup of A-D's signatures: {fresh} entries, "
              f"{len(engine.executor._graphs)} tick graphs in "
              f"{time.perf_counter() - start:.3f} s", flush=True)
        engine.executor.dispatch = timed("dispatch", engine.executor.dispatch)
        engine.scheduler.deliver = timed("deliver", engine.scheduler.deliver)
        engine.executor.n_dispatches = engine.executor.n_ticks = 0
        replays_before = engine.executor.n_replays
        graphs_before = len(engine.executor._graphs)
        WS_STAGE_DIAG.launches = WS_STAGE_DIAG.replayed_launches = 0
        WILLIAMSON2N.launches = 0
        torch.cuda.synchronize()
        start = time.perf_counter()
        rid_a, rid_b, rid_c, rid_d = (
            engine.submit(s, t1=t1, n_steps=n, n_paths=p, save_every=se, seed=seed)
            for s, t1, n, p, se, seed in ABC + (D_REQUEST,))
        done = engine.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - start
    n_paths = 6 * SERVE_SLOTS
    MEASURED["phase4_paths_per_s"] = n_paths / wall
    print(f"  served 4 requests, {n_paths} paths in {wall:.3f} s: "
          f"{n_paths / wall:.0f} paths/s (host wall clock incl. delivery); "
          f"n_dispatches={engine.executor.n_dispatches} "
          f"n_ticks={engine.executor.n_ticks}; ws_stage_diag launches="
          f"{WS_STAGE_DIAG.launches} ({WS_STAGE_DIAG.replayed_launches} of them replayed "
          f"from tick graphs)", flush=True)
    replays = engine.executor.n_replays - replays_before
    stats = engine.executor.graph_stats()
    print(f"  tick graphs: {stats['graphs']} captured in {stats['capture_s']:.3f} s "
          f"({stats['capture_s'] / max(1, stats['graphs']):.3f} s a graph, its eager "
          f"warm-up tick included; {stats['graphs'] - graphs_before} of them in the drain: "
          f"warmup captures a bucket's full-length tick), {replays} replays in the drain "
          f"for its {engine.executor.n_ticks} ticks, shared pool {stats['pool_mib']:.1f} "
          f"MiB", flush=True)
    check(replays == engine.executor.n_ticks,
          "a tick of the drain ran outside its tick graph")
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
    # the witnesses' launches are not the drain's
    counts = WS_STAGE_DIAG.launches, WS_STAGE_DIAG.replayed_launches
    graphed_vs_eager(torch, engine.executor)
    WS_STAGE_DIAG.launches, WS_STAGE_DIAG.replayed_launches = counts
    return params, y0, [done[rid_a], done[rid_b], done[rid_c]]


def _eager_tick(torch, executor, key, n_active, keys):
    """The eager ``sdeint_ticks`` call a tick graph of ``executor`` holds:
    ``key`` a signature or a bucket at ``n_active`` live steps."""
    from repro_torch.core import sdeint_ticks
    from repro_torch.serving import BucketKey

    common = dict(args=executor.args, noise_shape=executor.noise_shape,
                  dtype=executor.dtype, guard=executor.guard, device=executor.device,
                  mesh=executor.mesh, mesh_axis=executor.mesh_axis)
    if isinstance(key, BucketKey):
        return sdeint_ticks(executor.term, key.solver, key.t0, key.t0 + key.n_padded * key.h,
                            key.n_padded, executor.y0, keys, active_steps=(n_active,),
                            step_size=key.h, **common)
    solver, t0, t1, n_steps, save_every = key[:5]
    return sdeint_ticks(executor.term, solver, t0, t1, n_steps, executor.y0, keys,
                        save_every=save_every, **common)


def graphed_vs_eager(torch, executor):
    """One tick of each key the drain captured, replayed and through the
    eager ``sdeint_ticks`` on the same keys: bitwise on every output leaf."""
    from repro_torch.core import PRNGKey, path_keys
    from repro_torch.core.pytree import tree_flatten

    with torch.no_grad():
        for i, (key, n_active, slots) in enumerate(list(executor._graphs)):
            keys = path_keys(PRNGKey(500 + i, device="cuda"), slots)[None]
            got = executor.dispatch(key, keys, None if n_active is None else (n_active,))
            want = _eager_tick(torch, executor, key, n_active, keys)
            got, want = tree_flatten(got)[0], tree_flatten(want)[0]
            same = len(got) == len(want) and all(torch.equal(g, w) for g, w in zip(got, want))
            label = (f"{key.solver} bucket at {n_active} live" if n_active is not None
                     else f"{key[0]} t1={key[2]} n={key[3]} save_every={key[4]}")
            print(f"  graphed tick vs eager sdeint_ticks, {label}: {len(got)} leaves "
                  f"bitwise equal: {same}", flush=True)
            check(same, f"the graphed tick of {label} differs from the eager one")


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


def _zero_launches():
    from repro_torch.kernels import KERNELS

    for kern in KERNELS:
        kern.launches = 0


def _read_launches():
    from repro_torch.kernels import KERNELS

    return {kern.name: kern.launches for kern in KERNELS if kern.launches}


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
    _zero_launches()
    by_entry = dict(AXPY_CHAIN.entry_launches)
    rows = {}
    for name, spec, n_steps in t1.solvers():
        before = {kern.name: kern.launches for kern in KERNELS}
        r = t1.train_one(spec, n_steps, target, device="cuda")
        per_step = {kern.name: (kern.launches - before[kern.name]) / t1.EPOCHS
                    for kern in KERNELS if kern.launches > before[kern.name]}
        rows[name] = r
        us = r.seconds / t1.EPOCHS * 1e6
        if spec.startswith("ees25"):
            MEASURED["phase7_ees_us"] = us
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


def _peak_mib(torch, fn):
    """Peak device MiB allocated while ``fn`` runs, above what was allocated
    before it, and ``fn``'s result."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    out = fn()
    torch.cuda.synchronize()
    return (torch.cuda.max_memory_allocated() - base) / 2**20, out


def memory_phase(torch, timer):
    """Phase 8: peak memory of one EES(2,5) step under the reversible, full
    and recursive adjoints, the recursive step against the full one, and the
    profile of one reversible step."""
    from repro_torch.benchmarks import table1_ou as t1

    from repro_torch.core import TimeGrid, path_keys, prng
    from repro_torch.core.brownian import brownian_path

    target = t1.target_paths()
    peak_mib = lambda fn: _peak_mib(torch, fn)  # noqa: E731

    # "per-step noise" draws each step's increment in the loop (and again in
    # the backward sweep) instead of the bulk buffer: the adjoint alone.
    # "recursive" checkpoints chunks of the default remat_chunk (2 steps at
    # 8 steps, 4 at 64: segments of n/2).
    configs = (("reversible", dict(adjoint="reversible")),
               ("full", dict(adjoint="full")),
               ("recursive", dict(adjoint="recursive")),
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
    check(peaks[(64, "recursive")] < peaks[(64, "full")],
          "the recursive adjoint's peak is not below the full adjoint's")
    check(peaks[(64, "reversible")] < peaks[(64, "recursive")],
          "the reversible adjoint's peak is not below the recursive adjoint's")

    # One recursive step against one full step (8 steps, 65,536 paths): the
    # checkpointed replay runs the same kernels on the same inputs, so the
    # updated weights and the gradient norm must agree bit for bit (the CPU
    # test holds the gradients bitwise).
    after = {}
    for adjoint in ("full", "recursive"):
        step, state, params, key = _train_step(
            torch, "ees25:use_kernels=True", 8, target, n_paths=SERVE_SLOTS,
            adjoint=adjoint)
        params, _, m = step(params, state, key)
        after[adjoint] = ([p.detach().clone() for p in params.parameters()], m)
    (pf, mf), (pr, mr) = after["full"], after["recursive"]
    same = (all(torch.equal(a, b) for a, b in zip(pf, pr))
            and torch.equal(mf["grad_norm"], mr["grad_norm"]))
    print(f"  one EES(2,5) step ({SERVE_SLOTS} paths x 8 steps), recursive vs "
          f"full: updated weights max rel diff {_max_rel(pr, pf):.3e}, grad "
          f"norm {mr['grad_norm'].item():.9e} vs {mf['grad_norm'].item():.9e}, "
          f"bitwise={same}", flush=True)
    check(same, "the recursive adjoint's step differs from the full adjoint's")

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
# Profiled ticks of phase 9 (E, J, H, N and the m = 128 request's two specs):
# one each; reading a profile of 2k-20k launches is most of the phase's time
# (the m = 128 request took 81 s with two profiled ticks a spec).
TICK_PROFILE_REPS = 1
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
    from repro_torch.kernels import (INCREMENT_GENERAL, INCREMENT_PRE,
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
        _zero_launches()
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
    launches = _read_launches()
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
    start = time.perf_counter()
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
    print(f"  (the CPU runs: {time.perf_counter() - start:.1f} s)", flush=True)
    start = time.perf_counter()
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
            totals = timer.kernels_us(dispatch, reps=TICK_PROFILE_REPS, flush=False)
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
        dev_ms = sum(t for t, _ in totals.values()) / TICK_PROFILE_REPS / 1e3
        n_launch = sum(n for _, n in totals.values()) // TICK_PROFILE_REPS
        wall_ms = min(walls) * 1e3
        print(f"  one {label} tick ({SERVE_SLOTS} paths x {NOISE_STEPS} "
              f"steps): host wall {wall_ms:.3f} ms, device kernel time "
              f"{dev_ms:.3f} ms over {n_launch} launches (device busy "
              f"{dev_ms / wall_ms:.0%}); no host sync in the dispatch",
              flush=True)
        rows = sorted(((t / TICK_PROFILE_REPS, n // TICK_PROFILE_REPS, name)
                       for name, (t, n) in totals.items()), reverse=True)
        for us, n, name in rows[:6]:
            print(f"    {us / 1e3:8.3f} ms {n:5d}x  {name[:100]}", flush=True)
    print(f"  (the tick profiles: {time.perf_counter() - start:.1f} s)", flush=True)
    for name, eng in engines.items():
        stats = eng.executor.graph_stats()
        print(f"  {name} engine: {stats['graphs']} tick graphs captured in "
              f"{stats['capture_s']:.3f} s, {stats['replays']} replays for its "
              f"{eng.executor.n_ticks} ticks, shared pool {stats['pool_mib']:.1f} MiB",
              flush=True)
        check(stats["graphs"] > 0 and stats["replays"] == eng.executor.n_ticks,
              f"a tick of the {name} engine ran outside its tick graph")
    start = time.perf_counter()
    wide, wide_routes = wide_general_request(torch, timer)
    print(f"  (the m = {WIDE_CHANNELS} request: {time.perf_counter() - start:.1f} s)",
          flush=True)
    for name, n in wide.items():
        launches[name] = launches.get(name, 0) + n
    for name, by_route in wide_routes.items():
        routes[name] = {r: routes[name][r] + n for r, n in by_route.items()}
    return launches, routes


WIDE_CHANNELS = 128  # the reference kernel's lane-aligned width (its m % 128 == 0)
WIDE_PATHS = SERVE_SLOTS // 4  # the m = 128 request (its ticks are ~2.6 s at 65,536 paths)


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
    16,384 paths of the step-kernel benchmark's general term (d = 16) with
    m = 128 channels, ``ees25:use_kernels=True`` against plain ``ees25`` on
    the same seed (1e-5), with the device ms of one tick of each; returns the
    kernels' launches and the general kernels' launches by route."""
    from repro_torch.benchmarks import step_kernels as sk
    from repro_torch.core import PRNGKey, path_keys
    from repro_torch.serving import BucketKey, SDESampleConfig, SDESampleEngine

    term = sk.make_term("general", channels=WIDE_CHANNELS)
    cfg = SDESampleConfig(slots=SERVE_SLOTS, ticks_per_dispatch=2, guard_threshold=1e6)
    eng = SDESampleEngine(term, torch.ones(sk.DIM, device="cuda"), cfg,
                          args=sk.term_args("cuda"), noise_shape=(WIDE_CHANNELS,),
                          device="cuda")
    specs = ("ees25:use_kernels=True", "ees25")
    with torch.no_grad():
        for spec in specs:  # first use at full size, outside the count and the clock
            eng.submit(spec, t1=NOISE_T1, n_steps=NOISE_STEPS, n_paths=WIDE_PATHS, seed=99)
            eng.run()
        torch.cuda.synchronize()
        _zero_launches()
        routes_before = general_routes()
        rids, walls = {}, {}
        for spec in specs:
            start = time.perf_counter()
            rids[spec] = eng.submit(spec, t1=NOISE_T1, n_steps=NOISE_STEPS,
                                    n_paths=WIDE_PATHS, seed=51)
            eng.run()
            torch.cuda.synchronize()
            walls[spec] = time.perf_counter() - start
    launches = _read_launches()
    routes = general_routes(since=routes_before)
    got, want = (eng.done[rids[s]] for s in specs)
    for r in (got, want):
        check(r.y_final.shape == (WIDE_PATHS, sk.DIM) and bool(np.isfinite(r.y_final).all())
              and not r.diverged.any(), "the m = 128 request returned a bad sample")
    err = _rel(got.y_final, want.y_final)
    print(f"  m = {WIDE_CHANNELS} request ({WIDE_PATHS} paths, d = {sk.DIM}, "
          f"{NOISE_STEPS} steps): {specs[0]!r} vs {specs[1]!r}, same seed: max rel err "
          f"{err:.3e} (tolerance 1e-5); drains {walls[specs[0]]:.3f} s and "
          f"{walls[specs[1]]:.3f} s (host wall); kernel launches {launches}, general "
          f"kernels by route {routes}", flush=True)
    check(err <= 1e-5, "the m = 128 request: the kernel route disagrees with the plain route")
    check(eng.executor.n_replays == eng.executor.n_ticks,
          "a tick of the m = 128 request ran outside its tick graph")
    check(routes["ws_stage_general"]["staged"] > 0,
          "the m = 128 request launched no ws_stage_general kernel on the staged route")
    keys = path_keys(PRNGKey(7, device="cuda"), WIDE_PATHS)[None]
    for spec in specs:
        bucket = BucketKey(spec, 0.0, NOISE_T1 / NOISE_STEPS, NOISE_STEPS)
        with torch.no_grad():  # the unprofiled call captures this slot count's graph
            totals = timer.kernels_us(
                lambda: eng.executor.dispatch(bucket, keys, (NOISE_STEPS,)),
                reps=TICK_PROFILE_REPS, flush=False, warm=True)
        dev_ms = sum(us for us, _ in totals.values()) / TICK_PROFILE_REPS / 1e3
        general_ms = sum(us for name, (us, _) in totals.items()
                         if "general_kernel" in name) / TICK_PROFILE_REPS / 1e3
        print(f"  one m = {WIDE_CHANNELS} tick, {spec!r} ({WIDE_PATHS} paths x "
              f"{NOISE_STEPS} steps): device kernel time {dev_ms:.3f} ms, "
              f"{general_ms:.3f} ms of it in the general-noise kernels", flush=True)
        rows = sorted(((us / TICK_PROFILE_REPS, n // TICK_PROFILE_REPS, name)
                       for name, (us, n) in totals.items()), reverse=True)
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
    from repro_torch.kernels import INCREMENT_GENERAL, WS_STAGE_GENERAL, WS_STAGE_PRE
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
    _zero_launches()
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
    launches = _read_launches()
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


def _engine_drain(torch, cfg, params, prompts, max_len, eager=False):
    """One drain of ``prompts`` through a new decode Engine (a slot each,
    greedy): (tokens by request, host seconds, ticks, every logit finite,
    the engine's decode graph).  The Engine captures its step on the card;
    ``eager`` sets its step to the eager ``make_serve_step(cfg)`` instead
    (the graph is then None)."""
    from repro_torch.models import make_serve_step
    from repro_torch.serving import Engine, ServeConfig
    from repro_torch.serving.engine import _DecodeGraph

    eng = Engine(cfg, params, ServeConfig(slots=len(prompts), max_len=max_len))
    if eager:
        eng._step = make_serve_step(cfg)
    check(isinstance(eng._step, _DecodeGraph) != eager,
          f"{cfg.name}: the Engine's decode step is {'not ' * (not eager)}graphed")
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
    wall = time.perf_counter() - start
    graph = None if eager else step
    check(graph is None or graph.replays == ticks[0],
          f"{cfg.name}: a decode tick ran outside the Engine's graph")
    return done, wall, ticks[0], bool(torch.stack(finite).all()), graph


LM_SERVE_LEN = 32                # phase 12: the Engine's max_len (8-token prompts)


def lm_serve_phase(torch, timer, cfg, params):
    """Phase 12: zamba2-7b (bf16, full width and depth) served by the decode
    Engine: 8 requests of 8-token prompts, greedy; graphed, eager, and
    graphed again on a new engine, the same tokens each time."""
    prompts = np.random.default_rng(13).integers(2, cfg.vocab, size=(8, 8)).tolist()

    def drain(eager=False):
        return _engine_drain(torch, cfg, params, prompts, LM_SERVE_LEN, eager)

    first, wall, ticks, finite, graph = drain()
    new = sum(len(t) - len(p) for t, p in zip(first.values(), prompts))
    replay_s = wall - graph.capture_seconds
    print(f"  Engine(slots=8, max_len={LM_SERVE_LEN}), 8 requests x 8-token prompts, greedy, "
          f"graphed: {new} new tokens in {ticks} ticks, {wall:.3f} s = {new / wall:.1f} "
          f"tokens/s ({wall / ticks * 1e3:.1f} ms a tick, host wall clock incl. the "
          f"token-by-token prefill and the capture; {replay_s / ticks * 1e3:.1f} ms a "
          f"tick without the capture's {graph.capture_seconds:.3f} s); {graph.replays} "
          f"replays; logits finite: {finite}", flush=True)
    check(finite, "the served logits are not finite")
    check(len(first) == 8 and all(t[:8] == p for t, p in
                                  zip((first[i] for i in range(8)), prompts)),
          "the engine did not finish the 8 requests")
    eager, wall_e, ticks_e, _, _ = drain(eager=True)
    print(f"  the same drain with the eager make_serve_step(cfg) as the Engine's step: "
          f"{ticks_e} ticks, {wall_e:.3f} s ({wall_e / ticks_e * 1e3:.1f} ms a tick against "
          f"{replay_s / ticks * 1e3:.1f} ms replayed); the same tokens: {eager == first}",
          flush=True)
    check(eager == first, "the graphed Engine's tokens differ from the eager step's")
    second, wall2, _, _, graph2 = drain()
    same = second == first
    print(f"  a second graphed drain on a new engine ({wall2:.3f} s, {new / wall2:.1f} "
          f"tokens/s, capture {graph2.capture_seconds:.3f} s): the same tokens: {same}",
          flush=True)
    check(same, "a second drain returned other tokens")
    print(f"  request 0: prompt {prompts[0]} -> {first[0][8:16]} ...", flush=True)
    tick_profile(torch, timer, cfg, params)


def tick_profile(torch, timer, cfg, params):
    """One decode step of 8 slots, eager and as a replay of its graph: host
    wall, device time, launches."""
    from repro_torch.models import init_cache, make_serve_step
    from repro_torch.serving.engine import _DecodeGraph

    cache = init_cache(cfg, 8, 64, device="cuda")
    toks = torch.full((8,), 7, dtype=torch.int64, device="cuda")
    eager = make_serve_step(cfg)
    graph = _DecodeGraph(eager)
    for label, step in (("eager", lambda: eager(params, cache, toks, 9)),
                        ("a graph replay", lambda: graph(params, cache, toks, 9))):
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
        if dev_ms == 0:  # the profiler saw no kernel of the graph
            with torch.no_grad():
                dev_ms = timer.event_ms(step, reps=3, flush=False)
            print("  (the profiler recorded no kernel of the replay: device time from "
                  "CUDA events around it, launches not measured)", flush=True)
        print(f"  one serve_step (8 slots, {cfg.n_layers} layers), {label}: host wall "
              f"{wall_ms:.3f} ms, device kernel time {dev_ms:.3f} ms over {launches} "
              f"launches (device busy {dev_ms / wall_ms:.0%}; "
              f"{wall_ms / max(1, launches) * 1e3:.1f} us of host per launch)", flush=True)


# ---------------------------------------------------------------------------
# Phase 13: the paper's Euclidean experiments (Tables 7 and 2, the stability
# frontier) at the reference's own sizes.
# ---------------------------------------------------------------------------

def _finite_rel(torch, got, want):
    """max |got - want| / max |want| over the entries finite in both (so
    relative to ``want``'s own scale, however small); inf when the two are not
    finite at the same entries."""
    got, want = got.double().cpu(), want.double().cpu()
    ok = torch.isfinite(want)
    if not torch.equal(torch.isfinite(got), ok):
        return float("inf")
    err = (got[ok] - want[ok]).abs().max().item() if bool(ok.any()) else 0.0
    scale = want[ok].abs().max().item() if bool(ok.any()) else 0.0
    return err / scale if scale > 0 else (0.0 if err == 0 else float("inf"))


def _leaf_rel(torch, got, want):
    """The largest :func:`_finite_rel` over matching tensor lists: each leaf
    against its own largest entry."""
    return max(_finite_rel(torch, g, w) for g, w in zip(got, want))


def table7_phase(torch):
    """13a: Table 7 (benchmarks/table7_gbm.py), the four solvers through the
    kernels (the counted path), on the plain path on the card, and on the
    plain path on the CPU."""
    from repro_torch.benchmarks import table7_gbm as t7

    _zero_launches()
    kern = {name: t7.run_case(spec, n, device="cuda")
            for name, spec, n in t7.solvers(use_kernels=True)}
    torch.cuda.synchronize()
    launches = _read_launches()
    plain = {name: t7.run_case(spec, n, device="cuda")
             for name, spec, n in t7.solvers()}
    cpu = {name: t7.run_case(spec, n, device="cpu")
           for name, spec, n in t7.solvers()}
    for name, spec, n in t7.solvers(use_kernels=True):
        k, p, c = kern[name], plain[name], cpu[name]
        kp = _finite_rel(torch, k.y_final, p.y_final)
        kc = _finite_rel(torch, k.y_final, c.y_final)
        same = torch.equal(k.y_final, p.y_final)
        print(f"  table7_gbm/{name} ({spec}, {n} steps, {t7.N_PATHS} x {t7.D}): "
              f"terminal_max={k.terminal_max:.6e} stable={k.stable} (plain "
              f"{p.terminal_max:.6e}, CPU {c.terminal_max:.6e}); wall "
              f"{k.seconds * 1e3:.3f} ms with the kernels, {p.seconds * 1e3:.3f} "
              f"plain; kernels vs plain {kp:.2e} of max |y_T| (bitwise={same}; "
              f"must be bitwise), vs the CPU {kc:.2e} of max |y_T| (tolerance "
              f"1e-4)", flush=True)
        check(k.y_final.shape == (t7.N_PATHS, t7.D), f"Table 7 {name}: shape")
        check(same, f"Table 7 {name}: the kernels differ from the plain path")
        check(kc <= 1e-4, f"Table 7 {name}: the card disagrees with the CPU")
        check(k.stable == p.stable == c.stable, f"Table 7 {name}: stable differs")
    check(kern["EES(2,5)"].stable and not kern["RevHeun"].stable,
          "Table 7: the reference's outcome (EES(2,5) stable, Reversible Heun "
          "not) does not hold")
    return launches


def table2_phase(torch, timer):
    """13b: Table 2 (benchmarks/table2_vol.py) at its size: the four solvers
    under the reversible adjoint, kernels (the counted path) against plain,
    and the device's share of one EES(2,5) call; then EES(2,5) with the kernels under the full, recursive and reversible
    adjoints: gradients, peak memory and time."""
    from repro_torch.benchmarks import table2_vol as t2
    from repro_torch.core import prng
    from repro_torch.nsde import init_lsde

    target = torch.as_tensor(t2.target_paths(), dtype=torch.float32, device="cuda")
    key = prng.PRNGKey(0, device="cuda")
    params = init_lsde(key, 1, t2.D_Z, width=t2.WIDTH, device="cuda")

    def timed(loss):
        """(loss, grads, ms): one timed call (the kernels, the allocator and
        the solvers' code paths are warm from phases 7-12)."""
        torch.cuda.synchronize()
        start = time.perf_counter()
        val, grads = t2.value_and_grad(loss, params, key)
        val = val.item()
        return val, grads, (time.perf_counter() - start) * 1e3

    launches = {}
    for (name, spec, n), (_, plain, _) in zip(t2.solvers(use_kernels=True),
                                              t2.solvers()):
        _zero_launches()
        vk, gk, msk = timed(t2.make_loss(spec, n, target))
        torch.cuda.synchronize()
        for kname, cnt in _read_launches().items():
            launches[kname] = launches.get(kname, 0) + cnt
        vp, gp, msp = timed(t2.make_loss(plain, n, target))
        l_err, g_err = _loss_err([vk], [vp]), _leaf_rel(torch, gk, gp)
        print(f"  table2_vol/{name} ({n} steps, {t2.BATCH} paths, adjoint="
              f"reversible): {msk:.3f} ms per forward + backward with the "
              f"kernels, {msp:.3f} plain (host wall, one timed call); "
              f"sig_mmd={vk:.6f}; kernels vs plain: loss {l_err:.2e}, "
              f"gradients {g_err:.2e} of each leaf's max (tolerance 1e-5)",
              flush=True)
        check(np.isfinite(vk) and all(bool(torch.isfinite(g).all()) for g in gk),
              f"Table 2 {name}: not finite")
        check(l_err <= 1e-5 and g_err <= 1e-5,
              f"Table 2 {name}: the kernels disagree with the plain path")

    # The device's share of one call at 24 steps, 4 between observations
    # (a profile of the 168-step call's ~60k launches takes ~20 s to read).
    n_seg = 4 * t2.N_OBS
    loss = t2.make_loss("ees25:use_kernels=True", n_seg, target)
    run = lambda: t2.value_and_grad(loss, params, key)  # noqa: E731
    totals = timer.kernels_us(run, reps=1, flush=False)
    dev_ms = sum(t for t, _ in totals.values()) / 1e3
    n_launch = sum(n for _, n in totals.values())
    _, _, wall_ms = timed(loss)
    print(f"  table2_vol/EES(2,5) kernels, one forward + backward over {n_seg} steps: "
          f"device kernel time {dev_ms:.3f} ms over {n_launch} launches against "
          f"{wall_ms:.3f} ms of host wall (device busy {dev_ms / wall_ms:.1%})", flush=True)

    spec, n = "ees25:use_kernels=True", t2.NFE // 3
    seg = n // t2.N_OBS
    rows = {}
    for adjoint in ("full", "recursive", "reversible"):
        loss = t2.make_loss(spec, n, target, adjoint=adjoint)
        val, grads, ms = timed(loss)
        peak, _ = _peak_mib(torch, lambda: t2.value_and_grad(loss, params, key))
        per_step = t2.make_loss(spec, n, target, adjoint=adjoint,
                                bulk_increments=False)
        peak_ps, _ = _peak_mib(torch, lambda: t2.value_and_grad(per_step, params, key))
        rows[adjoint] = (val, grads, ms, peak, peak_ps)
    vf, gf = rows["full"][:2]
    for adjoint, (val, grads, ms, peak, peak_ps) in rows.items():
        same = val == vf and all(torch.equal(a, b) for a, b in zip(grads, gf))
        print(f"  table2_vol/EES(2,5) ({n} steps, segments of {seg}, adjoint="
              f"{adjoint}): {ms:.3f} ms per forward + backward; peak device "
              f"memory {peak:.3f} MiB ({peak_ps:.3f} MiB with per-step noise); "
              f"gradients vs full: {_leaf_rel(torch, grads, gf):.3e} of each "
              f"leaf's max (bitwise={same})",
              flush=True)
    rec, rev, full = rows["recursive"], rows["reversible"], rows["full"]
    check(rec[0] == full[0] and all(torch.equal(a, b) for a, b in zip(rec[1], full[1])),
          "Table 2: the recursive adjoint's gradients differ from the full adjoint's")
    check(_leaf_rel(torch, rev[1], full[1]) <= 1e-4,
          "Table 2: the reversible adjoint's gradients are far from the full "
          "adjoint's (tolerance 1e-4 of each leaf's max)")
    check(rev[4] < rec[4] < full[4], "Table 2 (per-step noise): peak memory is not "
          "reversible < recursive < full")
    check(rev[3] <= rec[3] < full[3], "Table 2: peak memory is not "
          "reversible <= recursive < full")
    return launches


def stability_phase(torch):
    """13c: the stability sweep (benchmarks/bench_stability.py) in full on the
    plain specs, and EES(2,5) / EES(2,7) through the kernels (the counted
    path), beside the reference's frontier from BENCH_stability.json."""
    from repro_torch.benchmarks import bench_stability as sweep

    with open(os.path.join(REPO, "BENCH_stability.json")) as f:
        ref = json.load(f)
    start = time.perf_counter()
    plain = sweep.run(device="cuda", verbose=False)
    plain_s = time.perf_counter() - start
    _zero_launches()
    start = time.perf_counter()
    kern = sweep.run(device="cuda", solvers=("ees25:use_kernels=True",
                                             "ees27:use_kernels=True"),
                     verbose=False)
    kern_s = time.perf_counter() - start
    torch.cuda.synchronize()
    launches = _read_launches()
    n_runs = len(plain["records"])
    print(f"  {n_runs} plain runs in {plain_s:.2f} s, "
          f"{len(kern['records'])} kernel runs in {kern_s:.2f} s "
          f"({sweep.N_PATHS} paths x {sweep.DIM}, float64)", flush=True)
    diffs = 0
    for spec in sweep.SOLVERS:
        for lam in (f"{x:g}" for x in sweep.STIFFNESS):
            got, want = plain["frontiers"][spec][lam], ref["frontiers"][spec][lam]
            same = got == want
            diffs += not same
            print(f"    {spec:16s} lam {lam:>2s}: max_stable_h "
                  f"{got['max_stable_h']:.6g} min_budget {got['min_stable_budget']}"
                  f"  (reference: {want['max_stable_h']:.6g}, "
                  f"{want['min_stable_budget']}){'' if same else '  DIFFERS'}",
                  flush=True)
    flips = sum(r["stable"] != q["stable"] for r, q in zip(
        plain["records"], ref["records"]))
    print(f"  frontiers differing from the reference's: {diffs}; runs whose "
          f"stable flag differs: {flips} of {n_runs}", flush=True)
    for spec in ("ees25", "ees27"):
        same = kern["frontiers"][f"{spec}:use_kernels=True"] == plain["frontiers"][spec]
        print(f"  {spec}:use_kernels=True frontier equals plain {spec}'s: {same}",
              flush=True)
        check(same, f"the {spec} kernel route's frontier differs from the plain route's")
    bad = sweep.gate(plain)
    print(f"  the reference's gate (EES(2,5)'s frontier finite, positive and >= "
          f"Reversible Heun's at every stiffness): {'pass' if not bad else bad}",
          flush=True)
    check(not bad, "the stability gate fails")
    return launches


def paper_tables_phase(torch, timer):
    """Phase 13: returns ``{kernel: launches}`` summed over 13a-13c."""
    total = {}
    for label, fn, must in (
            ("13a: Table 7, stiff GBM", table7_phase,
             ("increment_diag", "ws_stage_diag", "axpy_chain")),
            ("13b: Table 2, rough volatility", lambda torch: table2_phase(torch, timer),
             ("increment_diag", "ws_stage_diag", "ws_stage_diag_bwd", "axpy_chain")),
            ("13c: the stability frontier", stability_phase, ("ws_stage_diag",))):
        start = time.perf_counter()
        print(f" {label}", flush=True)
        launches = fn(torch)
        print(f"  kernels launched on {label[:3]}'s path: {launches} "
              f"({time.perf_counter() - start:.1f} s)", flush=True)
        for name in must:
            check(launches.get(name, 0) > 0,
                  f"{name} was not launched on phase {label[:3]}'s path")
        for name, n in launches.items():
            total[name] = total.get(name, 0) + n
    return total


# ---------------------------------------------------------------------------
# Phase 14: the async serving plane, fault injection, warmup and the
# persistent kernel cache, on phase 4's model and requests A-C.
# ---------------------------------------------------------------------------



def _async_drain(torch, engine, rounds: int = 1, on_round=None):
    """Submit A-C to an async engine ``rounds`` times and await their device
    results; returns ``(results of the last round, its seconds from the
    first submit to the last result on the device, counters)``.
    ``on_round(i, results)`` sees each round's results."""
    import asyncio

    async def serve():
        async with engine:
            for i in range(rounds):
                start = time.perf_counter()
                rids = [await engine.submit(s, t1=t1, n_steps=n, n_paths=p,
                                            save_every=se, seed=seed)
                        for s, t1, n, p, se, seed in ABC]
                results = [await engine.result(r) for r in rids]
                wall = time.perf_counter() - start
                if on_round is not None:
                    on_round(i, results)
            out = await engine.drain()
            return results, wall, out["counters"]

    return asyncio.run(serve())


def _same(torch, got, want) -> bool:
    """Device results bitwise equal to the sync drain's host arrays."""
    for name in ("y_final", "ys", "diverged"):
        g, w = getattr(got, name), getattr(want, name)
        if (g is None) != (w is None):
            return False
        if g is not None and not np.array_equal(g.cpu().numpy(), w):
            return False
    return True


_WARM_SCRIPT = r"""
import json, sys, time
sys.path.insert(0, sys.argv[1])
import torch
from repro_torch.kernels import KERNELS
from repro_torch.nsde import init_lsde, lsde_term
from repro_torch.serving import SDESampleConfig, SDESampleEngine
params = init_lsde(0, 1, 16, 32, device="cuda")
signatures = json.loads(sys.argv[3])
start = time.perf_counter()
engine = SDESampleEngine(lsde_term(), torch.zeros(16, device="cuda"),
                         SDESampleConfig(slots=65536, ticks_per_dispatch=2,
                                         compile_cache_dir=sys.argv[2]),
                         args=params, device="cuda")
fresh = engine.warmup(signatures)
seconds = time.perf_counter() - start
print(json.dumps({"seconds": seconds, "fresh": fresh,
                  "graphs": engine.executor.graph_stats(),
                  "nvcc_runs": {k.name: k.nvcc_runs for k in KERNELS if k.nvcc_runs},
                  "loaded": sorted(k.name for k in KERNELS if k._lib is not None)}))
"""


def warm_cache_subprocess(cache_dir: str, signatures) -> dict:
    """One fresh process that warms A-C's signatures with ``cache_dir`` as
    its compile cache; returns its report."""
    proc = subprocess.run(
        [sys.executable, "-c", _WARM_SCRIPT, SRC, cache_dir, json.dumps(signatures)],
        capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        fail(f"warmup subprocess exited {proc.returncode}:\n"
             f"{proc.stdout[-2000:]}{proc.stderr[-4000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def async_phase(torch, params, y0, sync_abc):
    """Phase 14: (a) the async engine serves A-C bitwise as phase 4's sync
    drain, through ws_stage_diag, on the executor's stream from any thread,
    with no host sync inside a steady-state dispatch; (b) under seeded NaN
    faults every request completes and the untouched ones are bitwise (a);
    (c) one injected crash restarts the loop once, bitwise (a); (d) warmup in
    a fresh process builds into a compile cache a second process loads from
    without nvcc.  Returns ws_stage_diag's launches over (a)-(c)."""
    import tempfile
    import threading
    import warnings

    from repro_torch.kernels import WS_STAGE_DIAG
    from repro_torch.nsde import lsde_term
    from repro_torch.serving import (AsyncSDESampleEngine, FaultConfig, SDESampleConfig,
                                     SDESampleEngine, inject_faults)
    from repro_torch.serving import executor as executor_mod

    cfg = SDESampleConfig(slots=SERVE_SLOTS, ticks_per_dispatch=2)
    n_paths = sum(r[3] for r in ABC)
    total_launches = 0

    # Sync paths/s of A-C on this config: the second of two drains.
    sync_eng = SDESampleEngine(lsde_term(), y0, cfg, args=params, device="cuda")
    for _ in range(2):
        for s, t1, n, p, se, seed in ABC:
            sync_eng.submit(s, t1=t1, n_steps=n, n_paths=p, save_every=se, seed=seed)
        torch.cuda.synchronize()
        start = time.perf_counter()
        sync_eng.run()
        sync_wall = time.perf_counter() - start

    # (a) Two async drains of A-C on one engine, the model's parameters
    # requiring gradients and autograd on: the first round's dispatches are
    # first dispatches (worker threads), the second's steady state (the loop
    # thread), each counted for host syncs under set_sync_debug_mode("warn").
    check(all(p.requires_grad for p in params.parameters()) and torch.is_grad_enabled(),
          "phase 14 serves a model whose parameters require gradients")
    main_thread = threading.get_ident()
    log = {"streams": set(), "threads": [], "syncs": [], "dispatch_streams": set(),
           "capture_streams": set(), "replay_streams": set(), "captures": []}
    real_launch = WS_STAGE_DIAG.launch

    def launch(fn, *args):
        # a launch while a tick graph is captured runs at its replays
        kind = "capture_streams" if torch.cuda.is_current_stream_capturing() else "streams"
        log[kind].add(torch.cuda.current_stream().cuda_stream)
        return real_launch(fn, *args)

    real_graph = executor_mod._TickGraph

    class LoggedGraph(real_graph):
        def __init__(self, *args):
            log["captures"].append("loop" if threading.get_ident() == main_thread
                                   else "worker")
            super().__init__(*args)

        def replay(self, keys):
            log["replay_streams"].add(torch.cuda.current_stream().cuda_stream)
            return super().replay(keys)

    engine = AsyncSDESampleEngine(lsde_term(), y0, cfg, args=params, device="cuda")
    executor = engine.executor
    real_dispatch = executor.dispatch

    host = {"dispatch": 0.0, "deliver": 0.0}

    def dispatch(key, tick_keys, active_steps=None):
        on_loop = threading.get_ident() == main_thread
        start = time.perf_counter()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            out = real_dispatch(key, tick_keys, active_steps)
        host["dispatch"] += time.perf_counter() - start
        log["threads"].append("loop" if on_loop else "worker")
        log["syncs"].append((on_loop, sum("synchroniz" in str(w.message)
                                          for w in caught)))
        log["dispatch_streams"].add(executor.stream.cuda_stream)
        return out

    real_deliver = engine.scheduler.deliver

    def deliver(*args, **kwargs):
        start = time.perf_counter()
        try:
            return real_deliver(*args, **kwargs)
        finally:
            host["deliver"] += time.perf_counter() - start

    def on_round(i, results):
        rounds.append(results)
        if i == 0:  # time the second, steady round only
            host.update(dispatch=0.0, deliver=0.0)

    executor.dispatch = dispatch
    engine.scheduler.deliver = deliver
    rounds = []
    WS_STAGE_DIAG.launches = 0
    WS_STAGE_DIAG.launch = launch
    executor_mod._TickGraph = LoggedGraph
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        clean, async_wall, counters = _async_drain(torch, engine, rounds=2,
                                                   on_round=on_round)
    finally:
        torch.cuda.set_sync_debug_mode("default")
        WS_STAGE_DIAG.launch = real_launch
        executor_mod._TickGraph = real_graph
    launches_a = WS_STAGE_DIAG.launches
    total_launches += launches_a
    steady = [n for on_loop, n in log["syncs"] if on_loop]
    exec_stream = executor.stream.cuda_stream
    print(f"  (a) async A-C, second round: {n_paths} paths in {async_wall:.3f} s: "
          f"{n_paths / async_wall:.0f} paths/s (submit to the last result on the "
          f"device); sync drain of A-C on the same config {sync_wall:.3f} s: "
          f"{n_paths / sync_wall:.0f} paths/s (to results on the host); "
          f"ws_stage_diag launches={launches_a} over both rounds; counters "
          f"{counters}", flush=True)
    print(f"  (a) host time in the second round: {host['dispatch']:.3f} s in "
          f"dispatches, {host['deliver']:.3f} s scattering results to requests "
          f"(a torch view per path and field, torch.stack at retirement), "
          f"{async_wall - host['dispatch'] - host['deliver']:.3f} s else "
          f"(planning, key packing, finalization, waiting on the device)",
          flush=True)
    print(f"  (a) dispatches by thread {log['threads']}; host syncs per dispatch "
          f"under set_sync_debug_mode('warn'): {[n for _, n in log['syncs']]} "
          f"(steady state, in the loop thread: {steady}); executor stream "
          f"{exec_stream:#x}; streams the dispatches entered "
          f"{sorted(map(hex, log['dispatch_streams']))}; streams ws_stage_diag "
          f"launched on {sorted(map(hex, log['streams']))} (eager: the captures' warm-up "
          f"ticks), captured on {sorted(map(hex, log['capture_streams']))}, replayed "
          f"on {sorted(map(hex, log['replay_streams']))}", flush=True)
    stats = executor.graph_stats()
    print(f"  (a) tick graphs captured by thread {log['captures']}, {stats['graphs']} in "
          f"{stats['capture_s']:.3f} s; {stats['replays']} replays for "
          f"{executor.n_ticks} ticks; shared pool {stats['pool_mib']:.1f} MiB", flush=True)
    check(launches_a > 0, "the async path launched no ws_stage_diag kernel")
    check(bool(steady) and max(steady) == 0,
          f"a steady-state async dispatch synchronized with the host: {steady}")
    check("worker" in log["threads"], "no dispatch ran in a worker thread")
    check(bool(log["captures"]) and set(log["captures"]) == {"worker"},
          "a tick graph was captured outside a worker thread")
    check(stats["replays"] == executor.n_ticks, "an async tick ran outside its tick graph")
    check(log["streams"] | log["replay_streams"] == {exec_stream} == log["dispatch_streams"],
          "a kernel launched or a graph replayed off the executor's stream")
    for results in rounds:
        for label, got, want in zip("ABC", results, sync_abc):
            check(got.y_final.is_cuda and not got.y_final.requires_grad,
                  f"async result {label} is off the device or carries an "
                  "autograd graph")
            check(_same(torch, got, want),
                  f"async request {label} differs from phase 4's sync drain")
    print("  (a) A-C bitwise equal to phase 4's sync drain in both rounds; no "
          "result requires grad", flush=True)

    # (b) Seeded NaN faults: every request completes; untouched ones are (a).
    # Seed 0's rate draws fire no NaN on A-C's three first dispatches, so one
    # cell of A (dispatch 0, tick 1, slot 5) is targeted on top of the rate.
    engine = AsyncSDESampleEngine(lsde_term(), y0, cfg, args=params, device="cuda")
    inj = inject_faults(engine, FaultConfig(seed=0, nan_rate=0.3,
                                            nan_slots=((0, 1, 5),)))
    WS_STAGE_DIAG.launches = 0
    faulty, wall, counters = _async_drain(torch, engine)
    total_launches += WS_STAGE_DIAG.launches
    untouched = [i for i, r in enumerate(faulty) if r.retries == 0]
    print(f"  (b) nan_rate=0.3, seed 0, A's cell (0, 1, 5): {wall:.3f} s; fired: dispatches "
          f"{inj.n_dispatch_calls}, NaN cells {inj.n_nans}; counters {counters}; "
          f"retries by request {[r.retries for r in faulty]}; ws_stage_diag "
          f"launches={WS_STAGE_DIAG.launches}", flush=True)
    check(len(faulty) == 3 and all(bool(torch.isfinite(r.y_final).all())
                                   and not r.diverged.any() for r in faulty),
          "a request under NaN faults did not complete clean")
    check(inj.n_nans >= 1 and faulty[0].retries >= 1
          and counters["retries"] >= 1 and counters["diverged_paths"] >= 1,
          "the injected NaN produced no divergence and no retry of A")
    for i in untouched:
        check(torch.equal(faulty[i].y_final, clean[i].y_final),
              f"request {'ABC'[i]}, untouched by faults, differs from (a)")
    print(f"  (b) untouched requests {[('ABC')[i] for i in untouched]} bitwise equal "
          f"to (a)", flush=True)

    # (c) One crash at the first dispatch: one supervised restart, bitwise (a).
    engine = AsyncSDESampleEngine(lsde_term(), y0, cfg, args=params, device="cuda")
    inj = inject_faults(engine, FaultConfig(crash_dispatches=(0,)))
    WS_STAGE_DIAG.launches = 0
    crashed, wall, counters = _async_drain(torch, engine)
    total_launches += WS_STAGE_DIAG.launches
    print(f"  (c) crash at dispatch 0: {wall:.3f} s; crashes {inj.n_crashes}, "
          f"restarts {counters['restarts']}", flush=True)
    check(inj.n_crashes == 1 and counters["restarts"] == 1,
          "the injected crash did not restart the serve loop exactly once")
    for label, got, want in zip("ABC", crashed, clean):
        check(torch.equal(got.y_final, want.y_final)
              and (want.ys is None or torch.equal(got.ys, want.ys)),
              f"request {label} after the restart differs from (a)")
    print("  (c) A-C after the restart bitwise equal to (a)", flush=True)

    # (d) Warmup in fresh processes sharing a compile cache.
    signatures = [dict(solver=s, t1=t1, n_steps=n, save_every=se)
                  for s, t1, n, _, se, _ in ABC]
    with tempfile.TemporaryDirectory() as cache_dir:
        cold = warm_cache_subprocess(cache_dir, signatures)
        warm = warm_cache_subprocess(cache_dir, signatures)
        libs = sorted(os.listdir(cache_dir))
    print(f"  (d) warmup of A-C's signatures in a fresh process: cold cache "
          f"{cold['seconds']:.3f} s ({cold['fresh']} entries, nvcc runs "
          f"{cold['nvcc_runs']}, loaded {cold['loaded']}, tick graphs captured "
          f"{cold['graphs']['graphs']} in {cold['graphs']['capture_s']:.3f} s); warm cache "
          f"{warm['seconds']:.3f} s ({warm['fresh']} entries, nvcc runs "
          f"{warm['nvcc_runs']}, tick graphs captured again {warm['graphs']['graphs']} in "
          f"{warm['graphs']['capture_s']:.3f} s: the cache holds kernel libraries, graphs "
          f"belong to their process); cache holds {libs}", flush=True)
    check(cold["graphs"]["graphs"] == warm["graphs"]["graphs"] > 0,
          "the warmups captured no tick graph, or different ones")
    check(cold["nvcc_runs"].get("ws_stage_diag", 0) == 1,
          "the cold warmup did not build ws_stage_diag into the cache")
    check(warm["nvcc_runs"] == {} and "ws_stage_diag" in warm["loaded"],
          "the warm-cache process ran nvcc or loaded nothing")
    check(cold["fresh"] == warm["fresh"] > 0, "warmup counts differ")
    return total_launches


# ---------------------------------------------------------------------------
# Phase 3 (per-path step sizes): the rows entries of the seven h-taking
# kernels, which adaptive solves and solves over realized grids launch with
# one h per path.
# ---------------------------------------------------------------------------

# (rows, d, offset): the served state, d = 3 (float32 16-byte packs straddle
# two paths) and an unaligned view of it.
ROWS_SHAPES = ((SERVE_SLOTS, D_Z, 0), (1001, 3, 0), (1001, 3, 1))
# The general pair's channels: the row route's main-path m = 4 and the
# staged route's m = 128 (each case's route checked).
ROWS_GENERAL_M = (4, WIDE_CHANNELS)


def rows_kernel_phase(torch, timer, stats):
    """The per-path entries bitwise against their twins with h varying per
    row, then timed at (65536, 16) float32 (the general pair at m = 4)
    beside the scalar entries."""
    from repro_torch.core.williamson import EES25_2N
    from repro_torch.kernels import INCREMENT_GENERAL, WS_STAGE_GENERAL
    from repro_torch.kernels.sde_step import ref as sref
    from repro_torch.kernels.sde_step.sde_step import (general_route, increment_diag,
                                                       increment_general, increment_pre,
                                                       route_launches, ws_stage_diag,
                                                       ws_stage_diag_bwd, ws_stage_general,
                                                       ws_stage_pre)

    a, b = EES25_2N.A[1], EES25_2N.B[1]
    gen = torch.Generator(device="cuda").manual_seed(4321)

    def draw(n, offset, dtype):
        return torch.randn(n + offset, generator=gen, device="cuda", dtype=dtype)[offset:]

    def inputs(n_in, rows, d, offset, dtype, m=None):
        """``n_in`` states (rows, d) (then g (rows, d, m) and dW (rows, m)
        when ``m``), offset views when ``offset``, and h (rows, 1)."""
        xs = [draw(rows * d, offset, dtype).view(rows, d) for _ in range(n_in)]
        if m is not None:
            xs += [draw(rows * d * m, offset, dtype).view(rows, d, m),
                   draw(rows * m, offset, dtype).view(rows, m)]
        h = torch.rand(rows, 1, generator=gen, device="cuda", dtype=dtype) * 0.2
        return xs, h

    def one(fn):
        return lambda xs, h: (fn(xs, h),)

    specs = {
        # name: n_in, streams and ops per element (float32 bytes / flops), the
        # profiler symbol, the scalar entry, the wrapper and its twin; the
        # general pair: the routed kernel, and per output the state streams
        # and the 2N update's extra ops.
        "ws_stage_diag_rows": dict(
            n_in=5, streams=7, ops=6, symbol="ws_stage_diag_kernel",
            scalar="ws_stage_diag",
            kernel=lambda xs, h: ws_stage_diag(*xs, h, a=a, b=b),
            plain=lambda xs, h: sref.ws_stage_diag_ref(*xs, h, a, b)),
        "ws_stage_diag_bwd_rows": dict(
            n_in=4, streams=8, ops=6, symbol="ws_stage_diag_bwd_kernel",
            scalar="ws_stage_diag_bwd",
            kernel=lambda xs, h: ws_stage_diag_bwd(*xs, h, a=a, b=b),
            plain=lambda xs, h: sref.ws_stage_diag_bwd_ref(*xs, h, a, b)),
        "increment_diag_rows": dict(
            n_in=3, streams=4, ops=3, symbol="increment_diag_kernel",
            scalar="increment_diag",
            kernel=one(lambda xs, h: increment_diag(*xs, h)),
            plain=one(lambda xs, h: sref.increment_diag_ref(*xs, h))),
        "increment_pre_rows": dict(
            n_in=2, streams=3, ops=2, symbol="increment_pre_kernel",
            scalar="increment_pre",
            kernel=one(lambda xs, h: increment_pre(*xs, h)),
            plain=one(lambda xs, h: sref.increment_pre_ref(*xs, h))),
        "ws_stage_pre_rows": dict(
            n_in=4, streams=6, ops=5, symbol="ws_stage_pre_kernel",
            scalar="ws_stage_pre",
            kernel=lambda xs, h: ws_stage_pre(*xs, h, a=a, b=b),
            plain=lambda xs, h: sref.ws_stage_pre_ref(*xs, h, a, b)),
        "increment_general_rows": dict(
            n_in=1, n_out=1, update_ops=0, symbol="increment_general_kernel",
            scalar="increment_general", routed=INCREMENT_GENERAL,
            kernel=one(lambda xs, h: increment_general(*xs, h)),
            plain=one(lambda xs, h: sref.increment_general_ref(*xs, h))),
        "ws_stage_general_rows": dict(
            n_in=3, n_out=2, update_ops=4, symbol="ws_stage_general_kernel",
            scalar="ws_stage_general", routed=WS_STAGE_GENERAL,
            kernel=lambda xs, h: ws_stage_general(*xs, h, a=a, b=b),
            plain=lambda xs, h: sref.ws_stage_general_ref(*xs, h, a, b)),
    }
    for name, spec in specs.items():
        routed = spec.get("routed")
        widths = ROWS_GENERAL_M if routed is not None else (None,)
        for dtype in (torch.float32, torch.float64):
            for m in widths:
                for rows, d, offset in ROWS_SHAPES:
                    xs, h = inputs(spec["n_in"], rows, d, offset, dtype, m)
                    took = ""
                    if routed is not None:
                        before = route_launches(routed)
                    got, want = spec["kernel"](xs, h), spec["plain"](xs, h)
                    torch.cuda.synchronize()
                    if routed is not None:
                        g, dW = xs[-2:]
                        expected = general_route(m, dtype, g.data_ptr() % 16 == 0
                                                 and dW.data_ptr() % 16 == 0)
                        after = route_launches(routed)
                        taken = [r for r in after if after[r] != before[r]]
                        check(taken == [expected], f"{name} {dtype} ({rows},{d},{m}) "
                              f"took the routes {taken}, not {expected}")
                        took = f" m={m}, {expected} route,"
                    abs_err, _, same = compare(torch, got, want)
                    print(f"  {name} {str(dtype)[6:]} (rows, d)=({rows},{d})"
                          f"{' unaligned' if offset else ''}{took}: max_abs_err="
                          f"{abs_err:.3e} bitwise={same} (h varies per row; "
                          f"tolerance 0)", flush=True)
                    check(same, f"{name} {dtype} ({rows},{d}) m={m} differs from its twin")
                    del xs, got, want
        m = ROWS_GENERAL_M[0] if routed is not None else None
        xs, h = inputs(spec["n_in"], SERVE_SLOTS, D_Z, 0, torch.float32, m)
        n = SERVE_SLOTS * D_Z
        if routed is None:
            bytes_moved, ops = spec["streams"] * n * 4, spec["ops"] * n
            label = f"float32 (rows, d)=({SERVE_SLOTS},{D_Z})"
        else:
            elems = n * m + SERVE_SLOTS * m + (spec["n_in"] + spec["n_out"]) * n
            bytes_moved, ops = elems * 4, n * (2 * m + 1 + spec["update_ops"])
            label = f"float32 (N,d,m)=({SERVE_SLOTS},{D_Z},{m}), row route"
        stats[name] = _timed_row(
            name, label, timer, lambda: spec["kernel"](xs, h),
            lambda: spec["plain"](xs, h), None, spec["symbol"],
            bytes_moved + SERVE_SLOTS * 4, ops, FP32_FLOPS, "float32", 0.0)
        scalar = stats[spec["scalar"]]
        print(f"  {name}: {stats[name]['ms'] * 1e3:.2f} us against the scalar "
              f"entry's {scalar['ms'] * 1e3:.2f} us (L2 flushed; "
              f"{stats[name]['ms_warm'] * 1e3:.2f} against "
              f"{scalar['ms_warm'] * 1e3:.2f} warm)", flush=True)
        del xs, h


# ---------------------------------------------------------------------------
# Phase 15: adaptive solves on Virtual Brownian Trees — served (O kernels,
# P plain), the card against the CPU in float64, and gradients over an
# adaptively realized grid.
# ---------------------------------------------------------------------------

ADAPTIVE_SAVE_AT = (0.5, 1.0, 1.5, 2.0)
# Request O (P is O with the plain spec): spec, t1, trial budget, paths, rtol.
ADAPTIVE_O = ("ees25:adaptive,use_kernels=True", 2.0, 256, SERVE_SLOTS, 1e-3, 31)
ADAPTIVE_CPU_PATHS = 256
ADAPTIVE_GRAD_PATHS = 4096
PROFILE_TRIALS = 4
# 15(b)'s gate on the controller's statistics over the 256 paths: the card
# against the CPU differs path by path as much as the card against itself
# with h0 one ulp up (sigma, per path).  The means of the counts, y_final
# and (y_final - mean)^2 must agree within MEAN_SIGMAS sigma / sqrt(paths),
# and the per-path differences' spread must stay within SPREAD_RATIO sigma
# (tests/test_torch_vbt_adaptive.py holds one-ulp h0 moves on the CPU to
# both limits).
MEAN_SIGMAS = 6.0
SPREAD_RATIO = 2.0


def _adaptive_requests():
    spec, t1, n, paths, rtol, seed = ADAPTIVE_O
    return [dict(solver=s, t1=t1, n_steps=n, n_paths=paths, rtol=rtol,
                 save_at=ADAPTIVE_SAVE_AT, seed=seed)
            for s in (spec, "ees25:adaptive")]


def _same_result(torch, got, want, fields=("y_final", "ys", "t_final",
                                           "n_accepted", "n_rejected")) -> bool:
    for name in fields:
        g, w = getattr(got, name), getattr(want, name)
        g = g.cpu().numpy() if isinstance(g, torch.Tensor) else g
        w = w.cpu().numpy() if isinstance(w, torch.Tensor) else w
        if not np.array_equal(g, w):
            return False
    return True


def _controller_statistics(torch, card, cpu, nudged):
    """The largest |mean(card - cpu)| in units of sigma / sqrt(paths), and the
    largest std(card - cpu) / sigma, over n_accepted, n_rejected, each
    component of y_final and of (y_final - its mean)^2; sigma is the std of
    card - nudged, the spread that one ulp of h0 makes."""
    def stats(r):
        y = r.y_final.cpu()
        return [r.n_accepted.cpu().double()[:, None],
                r.n_rejected.cpu().double()[:, None], y, (y - y.mean(0)) ** 2]

    worst_z = worst_ratio = 0.0
    for a, b, c in zip(stats(card), stats(cpu), stats(nudged)):
        sigma = (a - c).std(0)
        d = a - b
        n = d.shape[0]
        worst_z = max(worst_z, (d.mean(0).abs() / (sigma / n ** 0.5)).max().item())
        worst_ratio = max(worst_ratio, (d.std(0) / sigma).max().item())
    return worst_z, worst_ratio


def adaptive_phase(torch, timer, params, y0):
    """Phase 15 (a-c); returns the rows entries' launches on its paths."""
    import asyncio
    import copy

    from repro_torch.core import adaptive as ad
    from repro_torch.core import (PRNGKey, get_solver, path_keys, realize_grid, sdeint,
                                  solve, virtual_brownian_tree)
    from repro_torch.kernels import WS_STAGE_DIAG, WS_STAGE_DIAG_BWD
    from repro_torch.kernels.sde_step.sde_step import rows_launches
    from repro_torch.nsde import lsde_term
    from repro_torch.serving import AsyncSDESampleEngine, SDESampleConfig, SDESampleEngine

    term = lsde_term()
    spec_o, t1, budget, n_paths, rtol, seed = ADAPTIVE_O
    cfg = SDESampleConfig(slots=SERVE_SLOTS, ticks_per_dispatch=2)
    requests = _adaptive_requests()

    # (a) O and P through the sync engine.
    t_phase = time.perf_counter()
    with torch.no_grad():
        engine = SDESampleEngine(term, y0, cfg, args=params, device="cuda")
        warm = engine.submit(spec_o, t1=t1, n_steps=8, n_paths=1024, rtol=rtol,
                             seed=99)
        engine.run()
        del engine.done[warm]
        _zero_launches()
        WS_STAGE_DIAG.entry_launches.clear()
        WS_STAGE_DIAG_BWD.entry_launches.clear()
        ad.COUNTS.trials = ad.COUNTS.syncs = 0
        engine.executor.n_dispatches = engine.executor.n_ticks = 0
        torch.cuda.synchronize()
        start = time.perf_counter()
        rid_o = engine.submit(**requests[0])
        engine.run()
        torch.cuda.synchronize()
        o_wall = time.perf_counter() - start
        o_disp = engine.executor.n_dispatches
        o_counts = copy.copy(ad.COUNTS)
        launches = {"ws_stage_diag_rows": rows_launches(WS_STAGE_DIAG),
                    "ws_stage_diag": WS_STAGE_DIAG.launches}
        start = time.perf_counter()
        rid_p = engine.submit(**requests[1])
        engine.run()
        torch.cuda.synchronize()
        p_wall = time.perf_counter() - start
    res_o, res_p = engine.done[rid_o], engine.done[rid_p]
    # the controller reads the host between trials: adaptive keys run eagerly
    check(engine.executor.graph_stats()["graphs"] == 0, "an adaptive key captured a tick graph")
    check(launches["ws_stage_diag_rows"] > 0,
          "request O launched no per-path ws_stage_diag entry")
    check(launches["ws_stage_diag_rows"] == launches["ws_stage_diag"],
          "request O launched the scalar ws_stage_diag entry")
    check(res_o.y_final.shape == (n_paths, D_Z)
          and res_o.ys.shape == (n_paths, len(ADAPTIVE_SAVE_AT), D_Z),
          f"request O shapes {res_o.y_final.shape} {res_o.ys.shape}")
    check(bool(np.isfinite(res_o.y_final).all() and np.isfinite(res_o.ys).all()),
          "request O has non-finite samples")
    check(bool((res_o.t_final == t1).all()), "a path of O stopped short of t1")
    same_op = _same_result(torch, res_o, res_p)
    check(same_op, "O (kernels) and P (plain) differ")
    trials = o_counts.trials
    print(f"  O: {n_paths} paths in {o_wall:.3f} s ({n_paths / o_wall:.0f} paths/s, "
          f"host wall clock incl. delivery), {o_disp} dispatch(es) of 2 ticks; "
          f"{trials} trials ({trials / 2:.0f} a tick: the slowest path's), "
          f"{o_counts.syncs} host syncs ({o_counts.syncs / o_disp:.0f} a dispatch, "
          f"one every {ad.CHECK_EVERY} trials); accepted {res_o.n_accepted.mean():.2f} "
          f"and rejected {res_o.n_rejected.mean():.2f} steps a path (mean), "
          f"max trials of a path {int((res_o.n_accepted + res_o.n_rejected).max())}; "
          f"per-path ws_stage_diag launches {launches['ws_stage_diag_rows']}",
          flush=True)
    print(f"  P (plain): {n_paths / p_wall:.0f} paths/s; O == P bitwise (y_final, ys, "
          f"t_final, n_accepted, n_rejected): {same_op}; every t_final == {t1}",
          flush=True)

    # Device time per trial: one tick of O's paths, profiled at a short
    # budget (every kernel is built and warm from O's drain); host time per
    # trial: O's drain.
    keys = path_keys(PRNGKey(seed, device="cuda"), SERVE_SLOTS)
    with torch.no_grad():
        totals = timer.kernels_us(
            lambda: sdeint(term, spec_o, 0.0, t1, PROFILE_TRIALS, y0, None,
                           args=params, rtol=rtol, save_at=ADAPTIVE_SAVE_AT,
                           batch_keys=keys, bounded=False, device="cuda"),
            reps=1, flush=False, warm=False)
    dev_ms = sum(us for us, _ in totals.values()) / 1e3 / PROFILE_TRIALS
    host_ms = o_wall * 1e3 / trials
    launches_trial = sum(n for _, n in totals.values()) / PROFILE_TRIALS
    rng_ms = sum(us for name, (us, _) in totals.items()
                 if "elementwise" in name or "erfinv" in name.lower()) / 1e3 / PROFILE_TRIALS
    top = sorted(totals.items(), key=lambda kv: -kv[1][0])[:4]
    print(f"  a trial at {SERVE_SLOTS} paths: {dev_ms:.2f} ms of device time "
          f"(profiled, {PROFILE_TRIALS}-trial budget) in {host_ms:.2f} ms of host "
          f"wall (O's drain, delivery included; device busy {dev_ms / host_ms:.0%}), "
          f"{launches_trial:.0f} launches; elementwise and erfinv kernels "
          f"(threefry, the tree, the step's glue) {rng_ms:.2f} ms; top kernels: "
          + "; ".join(f"{name[:60]} {us / 1e3 / PROFILE_TRIALS:.2f} ms"
                      for name, (us, _) in top), flush=True)

    # O's first tick through the async engine (P equals O bitwise, checked
    # above); a path is keyed by its index, so these are O's first paths.
    # One tick, not O's two: the host-bound drain is the phase's longest.
    async def serve():
        async with AsyncSDESampleEngine(term, y0, cfg, args=params,
                                        device="cuda") as aeng:
            rid = await aeng.submit(**dict(requests[0], n_paths=SERVE_SLOTS))
            return await aeng.result(rid, numpy=True)

    start = time.perf_counter()
    async_o = asyncio.run(serve())
    a_wall = time.perf_counter() - start
    head = dataclasses.replace(res_o, **{
        f: getattr(res_o, f)[:SERVE_SLOTS]
        for f in ("y_final", "ys", "t_final", "n_accepted", "n_rejected")})
    same_async = _same_result(torch, async_o, head)
    check(same_async, "the async engine's O differs from the sync drain")
    print(f"  async engine: O's first {SERVE_SLOTS} paths bitwise equal to the sync "
          f"drain's: {same_async} ({SERVE_SLOTS / a_wall:.0f} paths/s)", flush=True)

    print(f"  (15a: {time.perf_counter() - t_phase:.1f} s)", flush=True)
    t_phase = time.perf_counter()

    # (b) The card against the CPU, float64, 256 of O's paths.
    p64 = copy.deepcopy(params).double()
    p_cpu = copy.deepcopy(p64).to("cpu")
    y64 = y0.double()
    k_card = path_keys(PRNGKey(seed, device="cuda"), ADAPTIVE_CPU_PATHS)
    k_cpu = k_card.cpu()
    opts = dict(rtol=rtol, save_at=ADAPTIVE_SAVE_AT)
    with torch.no_grad():
        card = sdeint(term, spec_o, 0.0, t1, budget, y64, None, args=p64,
                      batch_keys=k_card, bounded=False, device="cuda", **opts)
        cpu = sdeint(term, "ees25:adaptive", 0.0, t1, budget, y64.cpu(), None,
                     args=p_cpu, batch_keys=k_cpu, bounded=False, device="cpu",
                     **opts)
        # The card against itself, the first trial's step one ulp longer.
        nudged = sdeint(term, spec_o, 0.0, t1, budget, y64, None, args=p64,
                        batch_keys=k_card, bounded=False, device="cuda",
                        h0=float(np.nextafter(t1 / 16, t1)), **opts)
        same_counts = ((card.n_accepted.cpu() == cpu.n_accepted)
                       & (card.n_rejected.cpu() == cpu.n_rejected))
        self_counts = ((card.n_accepted == nudged.n_accepted)
                       & (card.n_rejected == nudged.n_rejected))
        gap = ((card.y_final.cpu() - cpu.y_final).abs().amax(-1)
               / cpu.y_final.abs().amax(-1))
        # One realized grid (bounded=True's phase 1), solved on the card
        # (its phase 2: bitwise the single pass) and on the CPU.
        tree = virtual_brownian_tree(k_card, 0.0, t1, shape=(D_Z,),
                                     dtype=torch.float64)
        y64b = y64.expand(ADAPTIVE_CPU_PATHS, D_Z).contiguous()
        rg = realize_grid(spec_o, term, y64b, tree, p64, rtol=rtol, max_steps=budget)
        on_card = solve(get_solver(spec_o), term, y64b, rg.grid, p64,
                        batch_dims=1).y_final
        check(torch.equal(on_card, card.y_final)
              and torch.equal(rg.n_accepted, card.n_accepted)
              and torch.equal(rg.n_rejected, card.n_rejected),
              "bounded=True and bounded=False differ on the card")
        grid_cpu = type(rg.grid)(rg.grid.ts.cpu(), virtual_brownian_tree(
            k_cpu, 0.0, t1, shape=(D_Z,), dtype=torch.float64), 0.0, t1,
            n_active=rg.grid.n_active, hs=rg.grid.hs.cpu())
        on_cpu = solve(get_solver("ees25"), term, y64b.cpu(), grid_cpu, p_cpu,
                       batch_dims=1).y_final
        grid_rel = ((on_card.cpu() - on_cpu).abs().amax(-1)
                    / on_cpu.abs().amax(-1)).max().item()
    print(f"  (b) float64, {ADAPTIVE_CPU_PATHS} of O's paths, controller on each "
          f"device: counts equal on {int(same_counts.sum())} paths, y_final within "
          f"{gap[same_counts].max().item() if same_counts.any() else float('nan'):.3e} "
          f"relative on those and {gap.max().item():.3e} on all; the card against "
          f"itself with h0 one ulp up: counts equal on {int(self_counts.sum())} "
          f"paths (the trial sequence amplifies any rounding difference)",
          flush=True)
    worst_z, worst_ratio = _controller_statistics(torch, card, cpu, nudged)
    print(f"  (b) the controller's statistics, card against CPU, in units of the "
          f"card-vs-nudged-card spread: means (counts, y_final, its variance) "
          f"within {worst_z:.2f} sigma/sqrt({ADAPTIVE_CPU_PATHS}) (limit "
          f"{MEAN_SIGMAS}), per-path spread {worst_ratio:.2f} sigma (limit "
          f"{SPREAD_RATIO})", flush=True)
    check(worst_z <= MEAN_SIGMAS,
          "the card's controller statistics are off the CPU's (means)")
    check(worst_ratio <= SPREAD_RATIO,
          "the card's controller strays from the CPU's path by path")
    print(f"  (b) one realized grid (the card's), solved on the card and on the CPU: "
          f"y_final within {grid_rel:.3e} relative (limit 1e-9); bounded=True "
          f"== bounded=False on the card bitwise", flush=True)
    check(grid_rel <= 1e-9, "the card and the CPU disagree on one realized grid")

    print(f"  (15b: {time.perf_counter() - t_phase:.1f} s)", flush=True)
    t_phase = time.perf_counter()

    # (c) Reversible-adjoint gradients over an adaptively realized grid: the
    # grid is realized once (the controller takes no gradient) and solved as
    # sdeint's bounded=True solves it, with each spec and adjoint.
    keys_g = path_keys(PRNGKey(seed, device="cuda"), ADAPTIVE_GRAD_PATHS)
    yg = y0.expand(ADAPTIVE_GRAD_PATHS, D_Z).contiguous()
    with torch.no_grad():
        grid_g = realize_grid(spec_o, term, yg, virtual_brownian_tree(
            keys_g, 0.0, t1, shape=(D_Z,)), params, rtol=rtol,
            max_steps=budget).grid

    def grads(spec, adjoint):
        model = copy.deepcopy(params)
        model.zero_grad()
        out = solve(get_solver(spec), term, yg, grid_g, model, adjoint=adjoint,
                    batch_dims=1)
        (out.y_final ** 2).mean().backward()
        # the encoder and readout are not on this loss's path
        return [p.grad.clone() for p in model.parameters() if p.grad is not None]

    _zero_launches()
    WS_STAGE_DIAG_BWD.entry_launches.clear()
    g_kern = grads(spec_o, "reversible")
    launches["ws_stage_diag_bwd_rows"] = rows_launches(WS_STAGE_DIAG_BWD)
    g_plain = grads("ees25:adaptive", "reversible")
    g_full = grads("ees25:adaptive", "full")
    same_grad = all(torch.equal(a, b) for a, b in zip(g_kern, g_plain))
    check(same_grad, "reversible gradients differ between kernels and plain")
    check(launches["ws_stage_diag_bwd_rows"] > 0,
          "the reversible replay launched no per-path ws_stage_diag_bwd entry")
    rel = max(((a - b).abs().max() / b.abs().max()).item()
              for a, b in zip(g_plain, g_full))
    print(f"  (c) {ADAPTIVE_GRAD_PATHS} paths: reversible gradients, kernels vs plain "
          f"bitwise: {same_grad} ({launches['ws_stage_diag_bwd_rows']} per-path "
          f"ws_stage_diag_bwd launches); reversible vs full: largest relative gap "
          f"{rel:.3e} (of each parameter's largest entry)", flush=True)

    # Peak memory of the three adjoints at 65,536 paths over one realized grid
    # of a 256-trial budget with bulk increments, and the reversible
    # adjoint's with per-step increments (a tree descent a step each way),
    # the one adjoint whose peak the increments' mode moves by a multiple.
    keys_m = path_keys(PRNGKey(seed, device="cuda"), SERVE_SLOTS)
    tree = virtual_brownian_tree(keys_m, 0.0, t1, shape=(D_Z,))
    yb = y0.expand(SERVE_SLOTS, D_Z).contiguous()
    with torch.no_grad():
        real_mib, rg = _peak_mib(torch, lambda: realize_grid(
            spec_o, term, yb, tree, params, rtol=rtol, max_steps=budget))
    mem, secs = {}, {}
    for adjoint, bulk in (("reversible", True), ("reversible", False),
                          ("recursive", True), ("full", True)):
        def step():
            model = copy.deepcopy(params)
            out = solve(get_solver(spec_o), term, yb, rg.grid, model,
                        adjoint=adjoint, bulk_increments=bulk, batch_dims=1)
            (out.y_final ** 2).mean().backward()
        start = time.perf_counter()
        mem[(adjoint, bulk)], _ = _peak_mib(torch, step)
        secs[(adjoint, bulk)] = time.perf_counter() - start
    print(f"  (c) peak device memory at {SERVE_SLOTS} paths, {budget}-trial grid "
          f"({rg.grid.n_active} live steps): realization {real_mib:.1f} MiB; "
          + ", ".join(f"{adj} {'bulk' if bulk else 'per-step'} {mib:.1f} MiB "
                      f"({secs[(adj, bulk)]:.1f} s)"
                      for (adj, bulk), mib in mem.items()), flush=True)
    check(mem[("reversible", False)] < mem[("full", True)],
          "the reversible adjoint does not save memory over the full one")
    print(f"  (15c: {time.perf_counter() - t_phase:.1f} s)", flush=True)
    return launches


# 15d: the other five per-path entries on the public paths that reach them.
# Adaptive solves (paths, trial budget, t1, rtol; at or under request O's
# 65,536 paths and 256 trials) and solves over one realized grid (paths):
# the Langevin model's diagonal noise (increment_diag and axpy_chain in
# Butcher and MCF stages, Milstein's increment, Reversible Heun), phase 9's
# general term (m = 4) and its additive term under the full adjoint with
# bulk increments (the prediffused pair).
PER_PATH_REQUEST = (SERVE_SLOTS // 4, 64, 1.0, 1e-2)
PER_PATH_GRID = 4096
PER_PATH_REL = 1e-5           # the general pair against einsum (phase 9's J vs L)
PER_PATH_MC_Z = 6.0           # adaptive general solves: means, in standard errors


def _mc_z(torch, a, b):
    """The largest |mean(a) - mean(b)| in standard errors of ``b``'s mean
    (std / sqrt(paths)) over n_accepted, n_rejected and each component of
    y_final: 0 where both are constant and equal, inf where only they
    differ."""
    worst = 0.0
    for x, y in ((a.n_accepted, b.n_accepted), (a.n_rejected, b.n_rejected),
                 (a.y_final, b.y_final)):
        x, y = x.double().reshape(x.shape[0], -1), y.double().reshape(y.shape[0], -1)
        gap = (x.mean(0) - y.mean(0)).abs()
        se = y.std(0) / y.shape[0] ** 0.5
        z = torch.where(gap == 0, torch.zeros_like(gap), gap / se)
        worst = max(worst, z.max().item())
    return worst
ROWS_KERNELS = ("increment_diag", "increment_pre", "ws_stage_pre", "increment_general",
                "ws_stage_general")


def per_path_phase(torch, params, y0):
    """15d: each per-path entry launched on a public path and held to the
    plain spec there; returns ``(rows launches, general rows launches by
    route, axpy_chain launches)``."""
    from repro_torch.benchmarks import step_kernels as sk
    from repro_torch.core import (PRNGKey, get_solver, path_keys, realize_grid, sdeint,
                                  solve, virtual_brownian_tree)
    from repro_torch.kernels import (AXPY_CHAIN, INCREMENT_DIAG, INCREMENT_GENERAL,
                                     INCREMENT_PRE, WS_STAGE_GENERAL, WS_STAGE_PRE)
    from repro_torch.kernels.sde_step.sde_step import route_launches, rows_launches
    from repro_torch.nsde import lsde_term
    from repro_torch.serving import SDESampleConfig, SDESampleEngine

    kernels = dict(zip(ROWS_KERNELS, (INCREMENT_DIAG, INCREMENT_PRE, WS_STAGE_PRE,
                                      INCREMENT_GENERAL, WS_STAGE_GENERAL)))
    n_paths, budget, t1, rtol = PER_PATH_REQUEST
    cfg = SDESampleConfig(slots=SERVE_SLOTS, ticks_per_dispatch=2, guard_threshold=1e6)
    langevin = lsde_term()
    args = sk.term_args("cuda")
    general, additive = sk.make_term("general"), sk.make_term("prediffused")
    engines = {"langevin": SDESampleEngine(langevin, y0, cfg, args=params, device="cuda")}
    requests = [("langevin", "heun:adaptive"), ("langevin", "milstein:adaptive")]

    def serve(engine, spec, seed):
        eng = engines[engine]
        rid = eng.submit(spec, t1=t1, n_steps=budget, n_paths=n_paths, rtol=rtol,
                         seed=seed)
        eng.run()
        return eng.done.pop(rid)

    def grid_solves(term, targs, shape, specs, y, grads=False):
        """One grid realized by ``ees25:adaptive`` at PER_PATH_GRID paths,
        solved with each spec with kernels and plain: {spec: (kernel y_final,
        plain y_final, kernel grads, plain grads)}; ``grads`` takes the
        gradients of mean(y_final^2) with respect to the dict ``targs``."""
        keys = path_keys(PRNGKey(77, device="cuda"), PER_PATH_GRID)
        yb = y.expand(PER_PATH_GRID, *y.shape).contiguous()
        with torch.no_grad():
            grid = realize_grid("ees25:adaptive", term, yb, virtual_brownian_tree(
                keys, 0.0, t1, shape=shape), targs, rtol=rtol, max_steps=budget).grid
        out = {}
        for spec in specs:
            runs = []
            for s in (f"{spec}:use_kernels=True", spec):
                leaves = ({k: v.clone().requires_grad_() for k, v in targs.items()}
                          if grads else targs)
                with torch.set_grad_enabled(grads):
                    res = solve(get_solver(s), term, yb, grid, leaves, adjoint="full",
                                batch_dims=1).y_final
                    g = (torch.autograd.grad((res ** 2).mean(), list(leaves.values()))
                         if grads else ())
                runs.append((res.detach(), g))
            out[spec] = (runs[0][0], runs[1][0], runs[0][1], runs[1][1])
        return grid, out

    with torch.no_grad():
        for engine, spec in requests:  # warm-up: allocator, first jvp, first launch
            engines[engine].submit(f"{spec},use_kernels=True", t1=t1, n_steps=8,
                                   n_paths=1024, rtol=rtol, seed=99)
            engines[engine].run()
            engines[engine].done.clear()
    _zero_launches()
    for kern in kernels.values():
        kern.entry_launches.clear()
    routes_before = {k: route_launches(kernels[k]) for k in ROWS_KERNELS[3:]}
    with torch.no_grad():
        served = {(engine, spec): (serve(engine, f"{spec},use_kernels=True", 61 + i),
                                   serve(engine, spec, 61 + i))
                  for i, (engine, spec) in enumerate(requests)}
    for (engine, spec), (kern, plain) in served.items():
        check(bool(np.isfinite(kern.y_final).all()), f"15d {engine} {spec}: non-finite")
        reached = float((kern.t_final == t1).mean())
        same = _same_result(torch, kern, plain, ("y_final", "t_final", "n_accepted",
                                                 "n_rejected"))
        print(f"  (d) {engine} '{spec},use_kernels=True' vs '{spec}', {n_paths} paths, "
              f"{budget}-trial budget, rtol {rtol}: bitwise (y_final, t_final, counts) "
              f"{same}; {reached:.1%} of paths at t1", flush=True)
        check(same, f"15d {engine} {spec}: kernels and plain differ")
    # Adaptive solves on the general term: the kernels sum g@dW in another
    # order than einsum, and the controller's error estimate (a difference
    # of stages whose noise parts nearly cancel) turns that rounding into
    # other accept sequences on some paths: per path the two are different
    # solutions within the tolerance.  So they are held as two Monte-Carlo
    # estimators of one law: the means of the counts and of y_final within
    # PER_PATH_MC_Z standard errors (the per-path 1e-5 holds over one
    # realized grid, below).
    keys = path_keys(PRNGKey(71, device="cuda"), n_paths)
    y_gen = torch.ones(sk.DIM, device="cuda")
    for spec in ("ees25:adaptive", "heun:adaptive"):
        with torch.no_grad():
            kern, plain = (sdeint(general, s, 0.0, t1, budget, y_gen, None, args=args,
                                  rtol=rtol, batch_keys=keys, bounded=False,
                                  noise_shape=(sk.N_CHANNELS,), device="cuda")
                           for s in (f"{spec},use_kernels=True", spec))
        agree = ((kern.n_accepted == plain.n_accepted)
                 & (kern.n_rejected == plain.n_rejected))
        rel = ((kern.y_final - plain.y_final).abs().amax(-1)
               / plain.y_final.abs().amax(-1))
        z = _mc_z(torch, kern, plain)
        ok = all(bool(torch.isfinite(r.y_final).all() and (r.t_final == t1).all())
                 for r in (kern, plain))
        print(f"  (d) general '{spec},use_kernels=True' vs '{spec}' (sdeint, {n_paths} "
              f"paths, {budget}-trial budget, rtol {rtol}): trial counts equal on "
              f"{agree.float().mean().item():.2%} of paths, y_final within "
              f"{PER_PATH_REL:g} relative on {(rel <= PER_PATH_REL).float().mean().item():.2%}"
              f" (at most {rel.max().item():.3e}); the means of the counts and of y_final "
              f"within {z:.2f} standard errors (limit {PER_PATH_MC_Z}); every path finite "
              f"at t1: {ok}", flush=True)
        check(ok and z <= PER_PATH_MC_Z,
              f"15d general {spec}: the kernels' samples are off the plain spec's")
    # solves over one realized grid: Reversible Heun and MCF on the Langevin
    # model; EES(2,5) and Heun on the general term; EES(2,5) and Reversible
    # Heun on the additive term under the full adjoint with bulk increments
    # (the prediffused route), with gradients
    _, lang = grid_solves(langevin, params, (D_Z,), ("reversible-heun", "mcf-midpoint"),
                          y0)
    _, gen = grid_solves(general, args, (sk.N_CHANNELS,), ("ees25", "heun"),
                                torch.ones(sk.DIM, device="cuda"))
    _, add = grid_solves(additive, args, (sk.DIM,), ("ees25", "reversible-heun"),
                                torch.ones(sk.DIM, device="cuda"), grads=True)
    for label, results, exact in (("langevin", lang, True), ("general", gen, False),
                                  ("additive (prediffused)", add, True)):
        for spec, (yk, yp, gk, gp) in results.items():
            if exact:
                ok = torch.equal(yk, yp) and all(torch.equal(a, b) for a, b in zip(gk, gp))
                what = f"bitwise{' (y_final and gradients)' if gk else ''}: {ok}"
            else:
                rel = ((yk - yp).abs().max() / yp.abs().max()).item()
                ok = rel <= PER_PATH_REL
                what = f"max rel err {rel:.3e} (limit {PER_PATH_REL})"
            print(f"  (d) {label} over one realized grid ({PER_PATH_GRID} paths), "
                  f"'{spec}:use_kernels=True' vs '{spec}': {what}", flush=True)
            check(ok and bool(torch.isfinite(yk).all()),
                  f"15d {label} {spec}: kernels and plain differ over a realized grid")
    launches = {name: rows_launches(kernels[name]) for name in ROWS_KERNELS}
    by_route = {name: {r: n - routes_before[name][r]
                       for r, n in route_launches(kernels[name]).items()}
                for name in ROWS_KERNELS[3:]}
    axpy = AXPY_CHAIN.launches
    print(f"  (d) per-path entries launched on 15d's paths: {launches}; the general "
          f"pair's by route {by_route}; axpy_chain {axpy}", flush=True)
    for name, n in launches.items():
        check(n > 0, f"the per-path {name} entry was not launched on 15d's paths")
    check(axpy > 0, "axpy_chain was not launched on 15d's Butcher and MCF paths")
    return launches, by_route, axpy


# Phase 16: scanned training steps as CUDA graphs, microbatches, train_loop
# and resilient_train_loop with checkpoints, on the Table-1 model.
SCAN_K, SCAN_CHUNKS = 8, 2      # 16a-b: graphed chunks of 8 steps
FAULT_STEPS = (2, 3, 4, 9)      # 16d: a streak of three (a rollback at 4), then one
RESILIENT_STEPS, RESILIENT_K = 12, 4
LOOP_STEPS, LOOP_K = 10, 4      # 16e
MICROBATCHES = 4                # 16c
PHASE16_KERNELS = ("ws_stage_diag", "ws_stage_diag_bwd", "increment_diag",
                   "axpy_chain")


def _pair_equal(torch, a, b) -> bool:
    """Bitwise equality of two (LSDE, optimizer state) pairs."""
    from repro_torch.core.pytree import tree_leaves

    (pa, oa), (pb, ob) = a, b
    return (all(torch.equal(x, y) for x, y in zip(pa.parameters(), pb.parameters()))
            and all(torch.equal(x, y)
                    for x, y in zip(tree_leaves(oa), tree_leaves(ob))))


def _wall_s(torch, fn) -> float:
    """Host wall seconds of ``fn`` up to the end of its device work."""
    torch.cuda.synchronize()
    start = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - start


def _device_ms(timer, fn):
    """Device kernel ms and kernel count of one profiled call of ``fn``
    ((None, 0) when the profiler saw no device time)."""
    totals = timer.kernels_us(fn, reps=1, flush=False, warm=False)
    us = sum(t for t, _ in totals.values())
    return (us / 1e3 if us > 0 else None), sum(n for _, n in totals.values())


def _lsde_step(torch, spec, device, *, dtype=None, n_paths=256, loss=None,
               optimizer=None, **kw):
    """A Table-1 LSDE step on ``device`` (weights ``init_lsde(0)``; key
    ``PRNGKey(1)``; ``loss(p, r)`` defaults to the moment MSE against the
    Table-1 target, ``optimizer`` to AdamW at 1e-2); returns (step,
    optimizer, params, state, key)."""
    from repro_torch.benchmarks import table1_ou as t1
    from repro_torch.core import prng
    from repro_torch.nsde import init_lsde, lsde_readout, lsde_term, moment_mse
    from repro_torch.optim import adamw
    from repro_torch.train import make_sde_train_step

    dtype = dtype or torch.float32
    params = init_lsde(0, t1.D_OBS, t1.D_Z, t1.WIDTH, dtype=dtype, device=device)
    if loss is None:
        tgt = torch.as_tensor(t1.target_paths(), dtype=dtype, device=device)
        loss = lambda p, r: moment_mse(lsde_readout(p, r.ys)[..., 0], tgt)  # noqa: E731
    opt = optimizer or adamw(1e-2)
    step = make_sde_train_step(
        spec, lsde_term(), opt,
        y0_fn=lambda p: torch.zeros(t1.D_Z, dtype=dtype, device=device) + p.encoder.b,
        loss_fn_result=loss, t0=0.0, t1=t1.T, n_paths=n_paths, device=device,
        **kw)
    return (step, opt, params, opt.init(list(params.parameters())),
            prng.PRNGKey(1, device=device))


def _launch_counts():
    from repro_torch.kernels import KERNELS

    return {k.name: (k.host_launches, k.replayed_launches) for k in KERNELS}


def scan_graph_phase(torch, timer):
    """16a: every Table-1 spec (and EES(2,5) under the full and recursive
    adjoints), 2 graphed chunks of 8 against 16 sequential steps, bitwise;
    ms a step, busy share, capture seconds; a replay's launch bookkeeping;
    an adaptive step stays eager."""
    from repro_torch.benchmarks import table1_ou as t1
    from repro_torch.core import prng
    from repro_torch.train import init_scan_counters, make_scanned_step

    n_total = SCAN_K * SCAN_CHUNKS
    cases = [(name, spec, n, "reversible") for name, spec, n in t1.solvers()]
    _, ees_spec, ees_n, _ = next(c for c in cases if c[1].startswith("ees25"))
    cases += [(f"EES(2,5) {adj}", ees_spec, ees_n, adj) for adj in ("full", "recursive")]
    for name, spec, n_steps, adjoint in cases:
        t_case = time.perf_counter()
        kw = dict(n_steps=n_steps, save_every=n_steps // 2, adjoint=adjoint)
        step, _, params, state, key = _lsde_step(torch, spec, "cuda", **kw)
        losses, skipped = [], []

        def sequential(steps, offset=0):
            nonlocal params, state
            for i in range(offset, offset + steps):
                params, state, m = step(params, state, prng.fold_in(key, i))
                losses.append(m["loss"])
                skipped.append(m["skipped"])

        # The first chunk's steps warm the path up; the second's are timed.
        sequential(n_total - SCAN_K)
        seq_s = _wall_s(torch, lambda: sequential(SCAN_K, n_total - SCAN_K))
        step_g, _, params_g, state_g, key_g = _lsde_step(torch, spec, "cuda", **kw)
        scanned = make_scanned_step(step_g, SCAN_K)
        counters = init_scan_counters("cuda")
        hists = []
        for c in range(SCAN_CHUNKS):
            params_g, state_g, counters, h = scanned(params_g, state_g, counters,
                                                     key_g, c * SCAN_K)
            hists.append(h)
        torch.cuda.synchronize()
        check(scanned.graphed, f"16a {name}: the scanned step did not run as a "
              "CUDA graph")
        n_skipped = int(torch.stack(skipped).sum())
        same = (_pair_equal(torch, (params, state), (params_g, state_g))
                and torch.equal(torch.stack(losses),
                                torch.cat([h["loss"] for h in hists]))
                and torch.equal(torch.stack(skipped),
                                torch.cat([h["skipped"] for h in hists]))
                and int(counters["steps"]) == n_total
                and int(counters["skipped"]) == n_skipped)
        counted = (int(counters["steps"]), int(counters["skipped"]))
        # A call that only replays: the wrappers launch nothing from Python,
        # and the replayed count rises by the captured record.
        before = _launch_counts()
        replay_s = _wall_s(torch, lambda: scanned(params_g, state_g, counters,
                                                  key_g, n_total))
        after = _launch_counts()
        record = scanned.chunk.record.by_kernel()
        flat = all(after[k][0] == before[k][0] for k in after)
        rose = all(after[k][1] - before[k][1] == record.get(k, 0) for k in after)
        seq_ms, graph_ms = seq_s / SCAN_K * 1e3, replay_s / SCAN_K * 1e3
        busy = ""
        if spec == ees_spec and adjoint == "reversible":
            # Kernel time from the profiler over the host wall of the same
            # work unprofiled: 4 sequential steps, one replay of 8.
            seq_dev, seq_n = _device_ms(timer, lambda: sequential(4, n_total))
            graph_dev, graph_n = _device_ms(timer, lambda: scanned(
                params_g, state_g, counters, key_g, 2 * n_total))
            busy = ("; device kernel ms a step (profiler), kernels a step, busy "
                    "share: sequential " + (
                        f"{seq_dev / 4:.3f}, {seq_n / 4:.0f}, {seq_dev / 4 / seq_ms:.1%}"
                        if seq_dev else "not measured") + ", graphed " + (
                        f"{graph_dev / SCAN_K:.3f}, {graph_n / SCAN_K:.0f}, "
                        f"{graph_dev / SCAN_K / graph_ms:.1%}" if graph_dev
                        else "not measured (no kernel of the replay profiled)"))
        print(f"  16a {name} ({spec}, {n_steps} steps, adjoint={adjoint}): "
              f"{SCAN_CHUNKS} graphed chunks of {SCAN_K} vs {n_total} sequential "
              f"steps bitwise={same} (params, optimizer state, losses, skipped, "
              f"counters {counted[0]}/{counted[1]}); "
              f"ms a step (host wall) sequential {seq_ms:.3f} (the warm second "
              f"{SCAN_K}), graphed {graph_ms:.3f} (a replay); capture "
              f"{scanned.chunk.capture_seconds:.3f} s{busy}; captured launches "
              f"{record}; a replay: host launches flat={flat}, replayed launches "
              f"rose by the record={rose} ({time.perf_counter() - t_case:.1f} s)",
              flush=True)
        check(same, f"16a {name}: graphed chunks differ from sequential steps")
        check(record and flat and rose, f"16a {name}: the replay's launch "
              "bookkeeping is wrong")

    # An adaptive step reads its loop condition on the host: not capturable,
    # so the scanned step runs it eagerly and says so.
    step, _, params, state, key = _lsde_step(
        torch, "ees25:adaptive,use_kernels=True", "cuda", n_paths=16,
        n_steps=64, rtol=1e-2, atol=1e-4, save_at=(1.0, 2.0),
        loss=lambda p, r: torch.mean(r.ys ** 2))
    scanned = make_scanned_step(step, 2)
    _, _, counters, h = scanned(params, state, init_scan_counters("cuda"), key, 0)
    ok = (not step.capturable and not scanned.graphed
          and bool(torch.isfinite(h["loss"]).all()) and int(counters["steps"]) == 2)
    print(f"  16a adaptive EES(2,5) step: capturable={step.capturable}, "
          f"graphed={scanned.graphed}, losses {h['loss'].tolist()}", flush=True)
    check(ok, "16a: the adaptive step was captured or did not run")


def scan_memory_phase(torch):
    """16b: one EES(2,5) step widened to 65,536 paths x 8 steps, 8 steps
    graphed against 8 eager ones: bitwise, and peak memory."""
    from repro_torch.core import prng
    from repro_torch.train import init_scan_counters, make_scanned_step

    kw = dict(n_paths=SERVE_SLOTS, n_steps=8, save_every=4)
    step, _, params, state, key = _lsde_step(torch, "ees25:use_kernels=True",
                                             "cuda", **kw)

    def eager():
        nonlocal params, state
        for i in range(SCAN_K):
            params, state, _ = step(params, state, prng.fold_in(key, i))

    eager_mib, _ = _peak_mib(torch, eager)
    step_g, _, params_g, state_g, key_g = _lsde_step(
        torch, "ees25:use_kernels=True", "cuda", **kw)
    scanned = make_scanned_step(step_g, SCAN_K)
    counters = init_scan_counters("cuda")
    torch.cuda.empty_cache()
    reserved = torch.cuda.memory_reserved()
    first_mib, out = _peak_mib(torch, lambda: scanned(params_g, state_g, counters,
                                                      key_g, 0))
    torch.cuda.empty_cache()  # what stays reserved is the graph's pool
    held_mib = (torch.cuda.memory_reserved() - reserved) / 2**20
    same = _pair_equal(torch, (params, state), (out[0], out[1]))
    replay_mib, _ = _peak_mib(torch, lambda: scanned(out[0], out[1], out[2],
                                                     key_g, SCAN_K))
    print(f"  16b EES(2,5), {SERVE_SLOTS} paths x 8 steps: {SCAN_K} steps graphed "
          f"bitwise to {SCAN_K} eager steps={same}; peak device memory above "
          f"the inputs: eager {eager_mib:.1f} MiB (phase 8's one step: 337.0 MiB "
          f"in earlier runs), graphed {first_mib:.1f} MiB at capture and first "
          f"replay, {replay_mib:.1f} MiB a replay; the graph's pool holds "
          f"{held_mib:.1f} MiB of reserved memory after capture", flush=True)
    check(same, "16b: the graphed steps at 65,536 paths differ from eager steps")


def microbatch_phase(torch):
    """16c: microbatches = 4 against 1 at 256 paths in float64 (a
    path-decomposable loss), within the reference's own tolerance; the
    microbatched step graphed, bitwise to its sequential steps."""
    from repro_torch.core import prng
    from repro_torch.train import init_scan_counters, make_scanned_step

    def make(mb):
        return _lsde_step(torch, "ees25:use_kernels=True", "cuda",
                          dtype=torch.float64, n_steps=8, save_every=4,
                          microbatches=mb, loss=lambda p, r: torch.mean(r.y_final ** 2))

    runs = {}
    for mb in (1, MICROBATCHES):
        step, _, params, state, key = make(mb)
        params, state, m = step(params, state, key)
        runs[mb] = (float(m["loss"]), [p.detach().clone() for p in params.parameters()])
    (l1, p1), (l4, p4) = runs[1], runs[MICROBATCHES]
    loss_rel = abs(l4 - l1) / abs(l1)
    par_ok = all(torch.allclose(a, b, rtol=1e-9, atol=1e-12) for a, b in zip(p4, p1))
    par_rel = max(((a - b).abs() / b.abs().clamp_min(1e-300)).max().item()
                  for a, b in zip(p4, p1))
    step, _, params, state, key = make(MICROBATCHES)
    seq = []
    for i in range(2):
        params, state, m = step(params, state, prng.fold_in(key, i))
        seq.append(m["loss"])
    step_g, _, params_g, state_g, key_g = make(MICROBATCHES)
    scanned = make_scanned_step(step_g, 2)
    params_g, state_g, _, h = scanned(params_g, state_g, init_scan_counters("cuda"),
                                      key_g, 0)
    same = (scanned.graphed and _pair_equal(torch, (params, state), (params_g, state_g))
            and torch.equal(torch.stack(seq), h["loss"]))
    print(f"  16c microbatches={MICROBATCHES} vs 1, float64, 256 paths: loss "
          f"{l4:.17g} vs {l1:.17g} (rel {loss_rel:.2e}, tolerance 1e-12), updated "
          f"params max rel {par_rel:.2e} (rtol 1e-9, atol 1e-12: {par_ok}); the "
          f"microbatched step graphed (K=2) bitwise to sequential={same}", flush=True)
    check(loss_rel <= 1e-12 and par_ok, "16c: microbatches differ from the full batch")
    check(same, "16c: the graphed microbatched step differs from sequential steps")


def _gated_step(torch, device, faults):
    """A four-argument Table-1 EES(2,5) step whose loss is NaN at the global
    steps in ``faults`` (a gate set on the device from the step index)."""
    from repro_torch.benchmarks import table1_ou as t1
    from repro_torch.nsde import lsde_readout, moment_mse

    tgt = torch.as_tensor(t1.target_paths(), dtype=torch.float32, device=device)
    gate = torch.ones((), device=device)
    fault_t = torch.tensor(faults, dtype=torch.int64, device=device)
    base, opt, params, state, key = _lsde_step(
        torch, "ees25:use_kernels=True", device, n_steps=8, save_every=4,
        loss=lambda p, r: moment_mse(lsde_readout(p, r.ys)[..., 0], tgt) * gate)

    def faulty(p, o, k, s):
        gate.copy_(torch.where(torch.isin(s, fault_t), float("nan"), 1.0))
        return base(p, o, k)

    faulty.capturable = base.capturable
    return faulty, params, state, key


def resilient_phase(torch):
    """16d: resilient_train_loop with NaN losses at fixed steps, chunked
    (K = 4, graphed) against the same run on the CPU and stepwise; the
    fault-free chunked run against the stepwise run, bitwise."""
    import tempfile

    from repro_torch.train import ResilienceConfig, resilient_train_loop

    def run(device, faults, k):
        step, params, state, key = _gated_step(torch, device, faults)
        with tempfile.TemporaryDirectory() as d:
            return resilient_train_loop(
                step, params, state, key,
                res=ResilienceConfig(steps=RESILIENT_STEPS, ckpt_every=2, ckpt_dir=d,
                                     skip_patience=3, steps_per_call=k))

    card = run("cuda", FAULT_STEPS, RESILIENT_K)
    cpu = run("cpu", FAULT_STEPS, RESILIENT_K)
    stepwise = run("cuda", FAULT_STEPS, 1)
    summary = lambda r: (r["skipped"], r["rollbacks"], r["goodput"])  # noqa: E731
    print(f"  16d faults at steps {FAULT_STEPS}, {RESILIENT_STEPS} steps, K="
          f"{RESILIENT_K}: card skipped {card['skipped']}, rollbacks "
          f"{card['rollbacks']}, goodput {card['goodput']}; the CPU's "
          f"{summary(cpu)[1:]}, equal={summary(card) == summary(cpu)}; stepwise on "
          f"the card equal={summary(card) == summary(stepwise)}", flush=True)
    check(summary(card) == summary(cpu) and card["rollbacks"] >= 1,
          "16d: the card's rollbacks differ from the CPU's")
    check(summary(card) == summary(stepwise),
          "16d: the chunked loop's skips differ from the stepwise loop's")
    clean_k = run("cuda", (-1,), RESILIENT_K)
    clean_1 = run("cuda", (-1,), 1)
    same = (_pair_equal(torch, (clean_k["params"], clean_k["opt_state"]),
                        (clean_1["params"], clean_1["opt_state"]))
            and clean_k["losses"] == clean_1["losses"]
            and clean_k["skipped"] == clean_1["skipped"]
            and clean_k["goodput"] == clean_1["goodput"] == 1.0)
    print(f"  16d fault-free: chunked (K={RESILIENT_K}) bitwise to stepwise={same}",
          flush=True)
    check(same, "16d: the fault-free chunked loop differs from the stepwise loop")


class _StepIndex:
    """A step-pure data source whose batch is the step's own index."""

    def batch_at(self, step):
        return np.array([step], dtype=np.int64)


def train_loop_phase(torch):
    """16e: train_loop chunked (graphed) against stepwise, bitwise, and its
    dispatch count."""
    from repro_torch.core import prng
    from repro_torch.train import TrainLoopConfig, train_loop

    outs = {}
    for k in (1, LOOP_K):
        base, opt, params, _, key = _lsde_step(torch, "ees25:use_kernels=True",
                                               "cuda", n_steps=8, save_every=4)

        def step_fn(p, o, batch):
            return base(p, o, prng.fold_in(key, batch[0]))

        step_fn.capturable = base.capturable
        outs[k] = train_loop(None, params, _StepIndex(), optimizer=opt,
                             step_fn=step_fn,
                             loop=TrainLoopConfig(steps=LOOP_STEPS, log_every=1,
                                                  steps_per_call=k))
    a, b = outs[1], outs[LOOP_K]
    same = (_pair_equal(torch, (a["params"], a["opt_state"]),
                        (b["params"], b["opt_state"]))
            and a["losses"] == b["losses"])
    want = -(-LOOP_STEPS // LOOP_K)
    print(f"  16e train_loop, {LOOP_STEPS} steps: K={LOOP_K} bitwise to K=1="
          f"{same}; n_dispatches {b['n_dispatches']} (ceil(steps / K) = {want}) vs "
          f"{a['n_dispatches']}", flush=True)
    check(same, "16e: the chunked train_loop differs from the stepwise one")
    check(b["n_dispatches"] == want and a["n_dispatches"] == LOOP_STEPS,
          "16e: train_loop's dispatch count is wrong")


def training_pipeline_phase(torch, timer):
    """Phase 16 (a-e); returns the launches of its paths by kernel, device
    launches (eager plus replayed) and the replayed part."""
    from repro_torch.kernels import KERNELS

    for kern in KERNELS:
        kern.launches = kern.host_launches = kern.replayed_launches = 0
    for label, fn in (("16a", lambda: scan_graph_phase(torch, timer)),
                      ("16b", lambda: scan_memory_phase(torch)),
                      ("16c", lambda: microbatch_phase(torch)),
                      ("16d", lambda: resilient_phase(torch)),
                      ("16e", lambda: train_loop_phase(torch))):
        start = time.perf_counter()
        fn()
        print(f"  ({label}: {time.perf_counter() - start:.1f} s)", flush=True)
    launches = {k.name: k.launches for k in KERNELS if k.launches}
    replayed = {k.name: k.replayed_launches for k in KERNELS if k.replayed_launches}
    for name in PHASE16_KERNELS:
        check(replayed.get(name, 0) > 0,
              f"{name} was not launched by a graph replay on phase 16's paths")
    return launches, replayed



# ---------------------------------------------------------------------------
# Phase 17: manifolds — Tables 3 and 4 with their memory curves, served
# manifold requests, and the SO(3) convergence rates.
#
# Every step of these experiments is host-bound (hundreds of small launches
# a step), so the parts that need no result of the others run in worker
# processes beside the main one: the memory curves (three processes; each
# reads its own allocator's peak) and the CPU cross-checks.  The main process
# trains, serves and takes the card's rates meanwhile, then gates on what
# the workers report.
# ---------------------------------------------------------------------------

MANIFOLD_CHECK_EPOCHS = 2          # epochs of Tables 3 and 4 held against the CPU
MANIFOLD_PATHS = 2 * SERVE_SLOTS   # requests Q and R (two ticks each)
MANIFOLD_CPU_PATHS = 256           # Q's paths held against a CPU run
MANIFOLD_CPU_THREADS = 2           # the CPU worker's share of the host's cores
TORUS_DIM = 16
Q_SPEC = ("cfees25", 1.0, 10, 41)  # (spec, t1, n_steps, seed) of request Q
# The reference's refusal of a manifold spec on a Euclidean term
# (src/repro/serving/scheduler.py, make_request).
GEO_EM_MESSAGE = ("solver 'geo-em' is manifold-kind but this engine's term "
                  "needs a euclidean solver")


def _t3_case_keys(prng, device):
    """The key each Table-3 case starts from: the reference chains one key
    through the cases, ``EPOCHS`` splits a case."""
    from repro_torch.benchmarks import table3_kuramoto as t3

    key, keys = prng.PRNGKey(0, device=device), []
    for _ in t3.cases():
        keys.append(key)
        for _ in range(t3.EPOCHS):
            key = prng.split(key)[0]
    return keys, key


def _sphere_engine(torch, device, slots):
    """Table 4's parameters and its first trajectory's start on S^7 behind
    an engine on ``sphere_nsde_term(8)``."""
    from repro_torch.benchmarks import table4_sphere as t4
    from repro_torch.core import prng
    from repro_torch.nsde import sphere_nsde_term
    from repro_torch.serving import SDESampleConfig, SDESampleEngine

    key = prng.PRNGKey(0, device=device)
    return SDESampleEngine(sphere_nsde_term(t4.N_SPHERE), t4.data(key)[0][0],
                           SDESampleConfig(slots=slots), args=t4.init_params(key).sde,
                           noise_shape=(t4.M_NOISE,), device=device)


def _worker_table3_memory(torch, tag):
    """Fig 5b on the card: the per-step series at 32 / 128 / 512 steps or
    (``tag``) the bulk one at 32 and 512, each in a process of its own, on
    the parameters Table 3's run leaves off at (``init_kuramoto_nsde`` of
    the chained key)."""
    from repro_torch.benchmarks import table3_kuramoto as t3
    from repro_torch.core import prng
    from repro_torch.nsde import init_kuramoto_nsde

    _, key = _t3_case_keys(prng, "cuda")
    inputs = t3.data(device="cuda")
    params = init_kuramoto_nsde(key, t3.N, width=t3.WIDTH, device="cuda")
    ends = (t3.MEMORY_STEPS[0], t3.MEMORY_STEPS[-1])
    # A fresh process's first solve allocates what later ones reuse (the
    # cuBLAS workspace, ~64 MiB): one unread series first, so no reading
    # of the curve includes it.
    t3.memory_series(params, key, inputs, steps=ends[:1])
    if tag == "per-step":
        return t3.memory_series(params, key, inputs, bulk_increments=False)
    return t3.memory_series(params, key, inputs, steps=ends)


def _worker_table4_memory(torch, tag):
    """Fig 6 on the card, as Table 3's: reversible against full; ``tag``
    picks the per-step series (32 / 128 / 512) or the bulk one (32, 512),
    each in a process of its own (CF-EES(2,5)'s reversible backward is the
    longest host loop of the phase)."""
    from repro_torch.benchmarks import table4_sphere as t4
    from repro_torch.core import prng

    key = prng.PRNGKey(0, device="cuda")
    y0, labels = t4.data(key)
    params = t4.init_params(key)
    t4.memory_series(params, key, y0, labels, steps=t4.MEMORY_STEPS[:1])  # as Table 3's
    if tag == "per-step":
        return t4.memory_series(params, key, y0, labels, bulk_increments=False)
    return t4.memory_series(params, key, y0, labels,
                            steps=(t4.MEMORY_STEPS[0], t4.MEMORY_STEPS[-1]))


def _worker_cpu(torch):
    """The CPU side of phase 17's cross-checks: each case's first epochs of
    Tables 3 and 4 from the card's keys, request Q's first paths, and the
    SO(3) rates in float64."""
    from repro_torch.benchmarks import fig_convergence as fc
    from repro_torch.benchmarks import table3_kuramoto as t3
    from repro_torch.benchmarks import table4_sphere as t4
    from repro_torch.core import prng

    torch.set_num_threads(MANIFOLD_CPU_THREADS)
    out = {"t3": {}, "t4": {}}
    inputs = t3.data(device="cpu")
    keys, _ = _t3_case_keys(prng, "cpu")
    for (name, spec, adjoint, steps), key in zip(t3.cases(), keys):
        run, _ = t3.train_case(key, inputs, spec, adjoint, steps,
                               epochs=MANIFOLD_CHECK_EPOCHS)
        out["t3"][name] = run.losses
    key = prng.PRNGKey(0, device="cpu")
    y0, labels = t4.data(key)
    out["labels"] = labels.tolist()
    for name, spec, adjoint, steps in t4.cases():
        out["t4"][name] = t4.train_case(key, y0, labels, spec, adjoint, steps,
                                        epochs=MANIFOLD_CHECK_EPOCHS).losses
    engine = _sphere_engine(torch, "cpu", MANIFOLD_CPU_PATHS)
    spec, t1, n, seed = Q_SPEC
    with torch.no_grad():
        rid = engine.submit(spec, t1=t1, n_steps=n, n_paths=MANIFOLD_CPU_PATHS, seed=seed)
        out["q"] = engine.run()[rid].y_final.tolist()
    rates = fc.so3_rates(0.5, device="cpu")
    out["so3"] = {"errs": rates.errs, "rerrs": rates.rerrs, "fwd": rates.fwd,
                  "bwd": rates.bwd}
    return out


MANIFOLD_WORKERS = {
    "table3 memory, per-step": lambda torch: _worker_table3_memory(torch, "per-step"),
    "table3 memory, bulk": lambda torch: _worker_table3_memory(torch, "bulk"),
    "table4 memory, per-step": lambda torch: _worker_table4_memory(torch, "per-step"),
    "table4 memory, bulk": lambda torch: _worker_table4_memory(torch, "bulk"),
    "cpu": _worker_cpu,
}


def manifold_worker(name: str) -> None:
    """A phase-17 worker's entry (run in its own process): prints one JSON
    line."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    start = time.perf_counter()
    out = MANIFOLD_WORKERS[name](torch)
    print(json.dumps({"result": out, "seconds": round(time.perf_counter() - start, 1)}),
          flush=True)


def _start_worker(name):
    code = (f"import sys; sys.path[:0] = [{REPO!r}, {SRC!r}]; import chip_smoke; "
            f"chip_smoke.manifold_worker({name!r})")
    return subprocess.Popen([sys.executable, "-c", code], cwd=REPO, text=True,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE)


def _finish_worker(proc, name):
    """The worker's result; prints the seconds its work took."""
    out, err = proc.communicate(timeout=900)
    if proc.returncode != 0:
        fail(f"phase 17's {name} worker failed (rc {proc.returncode}): {err[-3000:]}")
    report = json.loads(out.strip().splitlines()[-1])
    print(f"  (17e, the {name} worker: {report['seconds']} s of work)", flush=True)
    return report["result"]


def _memory_gates(label, series, steps):
    """Figs 5b / 6 on the per-step series: the reversible peak's growth (or
    fall) below a tenth of the full adjoint's growth, the full adjoint's peak at least 8x
    from the first to the last step count, recursive (if run) below full."""
    rev, full = series["reversible"], series["full"]
    growth_rev, growth_full = rev[-1] - rev[0], full[-1] - full[0]
    print(f"  {label} gates (per-step increments): reversible growth "
          f"{growth_rev / 2**20:.3f} MiB vs full growth {growth_full / 2**20:.3f} MiB "
          f"(limit a tenth); full {full[-1] / max(full[0], 1):.2f}x from {steps[0]} to "
          f"{steps[-1]} steps (limit >= 8x)"
          + (f"; recursive {series['recursive'][-1] / 2**20:.3f} MiB vs full "
             f"{full[-1] / 2**20:.3f} MiB at {steps[-1]}" if "recursive" in series else ""),
          flush=True)
    check(abs(growth_rev) < 0.1 * growth_full,
          f"{label}: the reversible peak grows by more than a tenth of the full one's")
    check(full[-1] >= 8 * full[0], f"{label}: the full adjoint's peak grows less than 8x")
    if "recursive" in series:
        check(series["recursive"][-1] < full[-1],
              f"{label}: recursive is not below full at {steps[-1]} steps")


def _print_memory(label, result, steps):
    ends = (steps[0], steps[-1])
    for tag, at in (("per-step", steps), ("bulk", ends)):
        for adjoint, s in result[tag].items():
            print(f"  {label} {adjoint} ({tag} increments): peak MiB at {at} steps "
                  f"{[round(b / 2**20, 4) for b in s]} (bytes {s}); growth "
                  f"{s[-1] / max(s[0], 1):.2f}x", flush=True)
    _memory_gates(label, result["per-step"], steps)


def table3_card(torch):
    """17a on the card: Table 3's 15 epochs (repro_torch.benchmarks.
    table3_kuramoto) and CF-EES(2,5)'s reversible gradients against the full
    adjoint's."""
    from repro_torch.benchmarks import table3_kuramoto as t3
    from repro_torch.benchmarks.common import value_and_grad
    from repro_torch.core import prng
    from repro_torch.nsde import init_kuramoto_nsde

    card_in = t3.data(device="cuda")
    runs, key = t3.train(prng.PRNGKey(0, device="cuda"), card_in)
    params = init_kuramoto_nsde(key, t3.N, width=t3.WIDTH, device="cuda")
    th0, om0, tth, tom = card_in
    grads = {adj: value_and_grad(t3.make_loss("cfees25", adj, 20, tth, tom), params,
                                 key, th0, om0)
             for adj in ("reversible", "full")}
    err = _leaf_rel(torch, grads["reversible"][1], grads["full"][1])
    loss_err = abs(float(grads["reversible"][0]) - float(grads["full"][0]))
    print(f"  CF-EES(2,5), 20 steps: reversible gradients within {err:.2e} of each "
          f"leaf's max of the full adjoint's (tolerance 1e-4); losses differ by "
          f"{loss_err:.2e}", flush=True)
    check(err <= 1e-4, "Table 3: reversible gradients disagree with the full adjoint's")
    return runs


def table4_card(torch):
    """17b on the card: Table 4's 25 epochs a case and the accuracies."""
    from repro_torch.benchmarks import table4_sphere as t4
    from repro_torch.core import prng

    key = prng.PRNGKey(0, device="cuda")
    y0, labels = t4.data(key)
    return labels, {name: t4.train_case(key, y0, labels, spec, adjoint, steps)
                    for name, spec, adjoint, steps in t4.cases()}


def _print_runs(label, cases, runs, cpu, epochs, extra):
    for (name, spec, adjoint, steps), run in zip(cases, runs.values()):
        err = _loss_err(run.losses[:MANIFOLD_CHECK_EPOCHS], cpu[name])
        print(f"  {label}/{name} ({spec}, {adjoint}, {steps} steps, {epochs} epochs): "
              f"{extra(run)}, {run.seconds / epochs * 1e3:.3f} ms a step; first "
              f"{MANIFOLD_CHECK_EPOCHS} epochs {run.losses[:MANIFOLD_CHECK_EPOCHS]} vs "
              f"the CPU's {cpu[name]}: {err:.2e} relative (tolerance 1e-4)", flush=True)
        check(all(np.isfinite(run.losses)), f"{label} {name}: non-finite loss")
        check(err <= 1e-4, f"{label} {name}: the card disagrees with the CPU")


def _drain_paths_per_s(torch, engine, requests):
    """Submit ``requests`` ((spec, t1, n_steps, n_paths, seed)), drain, and
    return ({spec: result}, paths/s of the drain)."""
    ids = {spec: engine.submit(spec, t1=t1, n_steps=n, n_paths=p, seed=seed)
           for spec, t1, n, p, seed in requests}
    torch.cuda.synchronize()
    start = time.perf_counter()
    done = engine.run()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    return ({spec: done[rid] for spec, rid in ids.items()},
            sum(r[3] for r in requests) / seconds)


def manifold_serve_card(torch, params, y0):
    """17c on the card: requests Q and R on the sphere term, one torus
    request, and the Euclidean engine's refusal of a manifold spec; returns
    Q's samples."""
    from repro_torch.benchmarks import table4_sphere as t4
    from repro_torch.core import PRNGKey, ManifoldSDETerm, Torus, path_keys
    from repro_torch.nsde import lsde_term
    from repro_torch.serving import SDESampleConfig, SDESampleEngine

    spec, t1, n, seed = Q_SPEC
    requests = ((spec, t1, n, MANIFOLD_PATHS, seed), ("cfees27", t1, n, MANIFOLD_PATHS, 42))
    with torch.no_grad():
        engine = _sphere_engine(torch, "cuda", SERVE_SLOTS)
        engine.submit("cfees25", t1=1.0, n_steps=10, n_paths=1024, seed=7)
        engine.run()  # warm-up
        # A manifold tick (its batched expm included) must not wait on the
        # device either.
        tick_keys = path_keys(PRNGKey(7, device="cuda"), SERVE_SLOTS)[None]
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            engine.executor.dispatch(("cfees25", 0.0, 1.0, 10, None, None, None, None),
                                     tick_keys)
        except RuntimeError as exc:
            fail(f"a sphere dispatch synchronized with the host: {exc}")
        finally:
            torch.cuda.set_sync_debug_mode("default")
        print("  a sphere-term dispatch (cfees25, 65,536 paths) ran with "
              "torch.cuda.set_sync_debug_mode('error'): no host sync", flush=True)
        done, rate = _drain_paths_per_s(torch, engine, requests)
        for name, res in done.items():
            dev = float(np.abs(np.linalg.norm(res.y_final, axis=-1) - 1.0).max())
            print(f"  sphere S^7 request {name}: {res.y_final.shape} samples, max "
                  f"| |y| - 1 | = {dev:.2e} (tolerance 1e-5), finite="
                  f"{bool(np.isfinite(res.y_final).all())}", flush=True)
            check(res.y_final.shape == (MANIFOLD_PATHS, t4.N_SPHERE), f"{name}: shape")
            check(dev <= 1e-5, f"served sphere samples of {name} leave the sphere")
        print(f"  Q + R: {2 * MANIFOLD_PATHS} paths at {rate:.1f} paths/s (65,536 "
              f"slots, 10 steps, 28 noise channels)", flush=True)

        torus = ManifoldSDETerm(group=Torus(), drift=lambda t, y, a: 1.5 + torch.sin(y),
                                diffusion=lambda t, y, a: 0.8 + 0.2 * torch.cos(y))
        start = torch.linspace(-3.0, 3.0, TORUS_DIM, device="cuda")
        tengine = SDESampleEngine(torus, start, SDESampleConfig(slots=SERVE_SLOTS),
                                  device="cuda")
        tdone, trate = _drain_paths_per_s(torch, tengine,
                                          (("cfees25", 5.0, 20, SERVE_SLOTS, 43),))
        y = tdone["cfees25"].y_final
        print(f"  torus T^{TORUS_DIM} request cfees25 (t1 = 5, 20 steps): {y.shape}, "
              f"range [{y.min():.6f}, {y.max():.6f}] (must lie in [-pi, pi]), "
              f"{trate:.1f} paths/s", flush=True)
        check(y.shape == (SERVE_SLOTS, TORUS_DIM) and np.isfinite(y).all(), "torus shape")
        check(float(np.abs(y).max()) <= np.pi, "served torus samples leave [-pi, pi]")

        langevin = SDESampleEngine(lsde_term(), y0, SDESampleConfig(slots=SERVE_SLOTS),
                                   args=params, device="cuda")
        try:
            langevin.submit("geo-em", t1=1.0, n_steps=4, n_paths=8)
        except ValueError as exc:
            print(f"  'geo-em' on phase 4's Langevin engine: ValueError({exc})",
                  flush=True)
            check(str(exc) == GEO_EM_MESSAGE, "the refusal differs from the reference's")
        else:
            fail("the Langevin engine accepted a manifold solver")
    return done[spec].y_final


def so3_rates_gate(torch, card, cpu):
    """17d: Fig 8's SO(3) CF-EES(2,5) rates in float64, card against CPU."""
    from repro_torch.core import SO3

    fwd = max(abs(a - b) / b for a, b in zip(card.errs, cpu["errs"]))
    bwd = max(abs(a - b) / b for a, b in zip(card.rerrs, cpu["rerrs"]))
    # A recovery error is a difference of O(1) states: it carries their
    # rounding (~1e-16 absolute) however small it is.
    bwd_ok = all(abs(a - b) <= 1e-9 * b + 1e-14 for a, b in zip(card.rerrs, cpu["rerrs"]))
    dist = float(SO3().distance_from_manifold(card.y_ref))
    print(f"  SO(3) rates, card: fwd {card.fwd:.6f} bwd {card.bwd:.6f} (CPU "
          f"{cpu['fwd']:.6f} / {cpu['bwd']:.6f}); errors {card.errs} vs {cpu['errs']}: "
          f"{fwd:.2e} relative (tolerance 1e-9); recovery errors {card.rerrs} vs "
          f"{cpu['rerrs']}: {bwd:.2e} relative (tolerance 1e-9, or 1e-14 absolute); "
          f"the reference solution's distance from SO(3) {dist:.2e} (limit 1e-12)",
          flush=True)
    check(fwd <= 1e-9, "SO(3) forward errors: the card disagrees with the CPU")
    check(bwd_ok, "SO(3) recovery errors: the card disagrees with the CPU")
    check(dist < 1e-12, "the SO(3) reference solution left the group")


def manifold_phase(torch, params, y0):
    """Phase 17; returns the kernel launches counted over it (none: no TPU
    kernel lies on the manifold path)."""
    from repro_torch.benchmarks import fig_convergence as fc
    from repro_torch.benchmarks import table3_kuramoto as t3
    from repro_torch.benchmarks import table4_sphere as t4

    before = _read_launches()
    workers = {name: _start_worker(name) for name in MANIFOLD_WORKERS}
    card = {}
    try:
        for label, key, fn in (
                ("17a: Table 3, Kuramoto on T*T^16", "t3", lambda: table3_card(torch)),
                ("17b: Table 4, the latent SDE on S^7", "t4", lambda: table4_card(torch)),
                ("17c: served manifold requests (Q, R, torus)", "q",
                 lambda: manifold_serve_card(torch, params, y0)),
                ("17d: Fig 8's SO(3) rates, float64", "so3",
                 lambda: fc.so3_rates(0.5, device="cuda"))):
            start = time.perf_counter()
            print(f" {label}", flush=True)
            card[key] = fn()
            print(f"  ({label[:3]} on the card: {time.perf_counter() - start:.1f} s)",
                  flush=True)
        start = time.perf_counter()
        done = {name: _finish_worker(proc, name) for name, proc in workers.items()}
        print(f" 17e: the workers (Figs 5b and 6, the CPU's side) ended "
              f"{time.perf_counter() - start:.1f} s after the card's parts", flush=True)
    finally:
        for proc in workers.values():
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    cpu = done["cpu"]
    print(" 17a: Table 3 and Fig 5b", flush=True)
    _print_runs("table3_kuramoto", t3.cases(), card["t3"], cpu["t3"], t3.EPOCHS,
                lambda r: f"energy_score={r.losses[-1]:.6f} (first {r.losses[0]:.6f})")
    _print_memory("Fig 5b", {tag: done[f"table3 memory, {tag}"]
                             for tag in ("per-step", "bulk")}, t3.MEMORY_STEPS)
    print(" 17b: Table 4 and Fig 6", flush=True)
    labels, runs = card["t4"]
    check(labels.tolist() == cpu["labels"], "Table 4: labels differ from the CPU's")
    _print_runs("table4_sphere", t4.cases(), runs, cpu["t4"], t4.EPOCHS,
                lambda r: (f"loss={r.losses[-1]:.6f} (first {r.losses[0]:.6f}), "
                           f"acc={r.accuracy:.4f}"))
    _print_memory("Fig 6", {tag: done[f"table4 memory, {tag}"]
                            for tag in ("per-step", "bulk")}, t4.MEMORY_STEPS)
    print(" 17c: request Q against the CPU", flush=True)
    err = float(np.abs(card["q"][:MANIFOLD_CPU_PATHS] - np.asarray(cpu["q"])).max())
    print(f"  Q's first {MANIFOLD_CPU_PATHS} paths vs a CPU run: max abs difference "
          f"{err:.2e} (tolerance 1e-4)", flush=True)
    check(err <= 1e-4, "request Q disagrees with the CPU")
    print(" 17d: the SO(3) rates against the CPU", flush=True)
    so3_rates_gate(torch, card["so3"], cpu["so3"])
    after = _read_launches()
    return {k: n - before.get(k, 0) for k, n in after.items() if n != before.get(k, 0)}


LM_TRAIN_LAYERS = 12        # 18a: zamba2-7b cut from 81 layers (shared block at 0 and 6)
LM_TRAIN_BATCH, LM_TRAIN_LEN = 2, 2048  # phase 11's prefill shape
LM_TRAIN_STEPS = 4
LM_RESUME_LAYERS = 2        # 18a's resume check: full width, the shared block at layer 0
LM_GRAD_BATCH, LM_GRAD_LEN = 1, 512     # 18b
LM_GRAD_REL = 1e-4          # 18b: each gradient leaf, of its max|.|
SSD_Y_REL = 5e-4            # 18b: the forward ssd_scan's y from the float64 twin, of
                            # max|y| (the reference's kernel tolerance, tests/test_kernels.py)
EES_DEPTHS = (4, 8, 16)     # 18c: olmo-1b's depth is 16
EES_BATCH, EES_LEN = 4, 512
# 18c: reversible vs full adjoint, the whole gradient's relative distance.
# From h = embed[tokens] (init scale 0.02) one layer's F is ~35x the state,
# far outside the step sizes at which EES(2,5)'s inverse step rebuilds a
# layer's input, so the two adjoints' gradients part by O(1): 0.81 at
# d_model 256 on the CPU, in float32 and float64 alike (the reference's own
# ees_depth_solve shows the same).  The limit holds the reversible gradient
# to a finite, same-sized estimate; the port's correctness is held by the
# kernel-vs-plain gate and by the CPU tests against the reference.
EES_GRAD_GAP = 1.5
# 18c: the reversible gradients, kernel path vs plain path, each leaf of the
# larger of its own max|.| and 1% of the largest leaf's.  Rebuilding the
# states through 16 inverse steps amplifies float32 rounding: on the CPU (d
# 256) float32 and float64 reversible gradients part by 2.2e-5 of a leaf's
# max against the full adjoint's 3.7e-6.
EES_KERNEL_REL = 1e-3
LM_KERNELS = ("flash_attention", "ssd_scan", "flash_attention_bwd", "ssd_scan_bwd")
LM_GRAPH_K = 4              # 18e: 18a's steps a graphed chunk of train_loop


class _Microbatched:
    """A token source whose batches carry a leading microbatch axis, as the
    reference's accumulating step takes them."""

    def __init__(self, source, microbatches):
        self.source, self.microbatches = source, microbatches

    def batch_at(self, step):
        batch = self.source.batch_at(step)
        m = self.microbatches
        return {k: v.reshape(m, v.shape[0] // m, *v.shape[1:]) for k, v in batch.items()}


def _lm_train_run(torch, cfg, params, microbatches, steps, ckpt_dir=None, ckpt_every=100,
                  steps_per_call=1):
    """``train_loop`` with its default step on the synthetic stream, AdamW on
    the launcher's cosine schedule, each layer rematerialised (chunks of
    ``steps_per_call`` steps, CUDA graphs when more than one)."""
    from repro_torch.data import DataConfig, SyntheticTokens
    from repro_torch.models import ModelOptions
    from repro_torch.optim import adamw, cosine_schedule
    from repro_torch.train import TrainLoopConfig, train_loop

    data = SyntheticTokens(DataConfig(LM_TRAIN_BATCH, LM_TRAIN_LEN, cfg.vocab))
    if microbatches > 1:
        data = _Microbatched(data, microbatches)
    return train_loop(cfg, params, data,
                      optimizer=adamw(cosine_schedule(3e-4, 10, LM_TRAIN_STEPS)),
                      opts=ModelOptions(remat=True),
                      loop=TrainLoopConfig(steps=steps, log_every=1, ckpt_dir=ckpt_dir,
                                           ckpt_every=ckpt_every, microbatches=microbatches,
                                           steps_per_call=steps_per_call))


def _step_twice_bitwise(torch, step, params, state, batch, label):
    """One training step run twice from one state: the parameters must come
    out bitwise equal (the optimizer returns a new state and changes none in
    place, so both runs start from ``state``)."""
    snap = [p.detach().clone() for p in params.parameters()]
    results = []
    for _ in range(2):
        with torch.no_grad():
            for p, v in zip(params.parameters(), snap):
                p.copy_(v)
        step(params, state, batch)
        results.append([p.detach().clone() for p in params.parameters()])
    same = all(torch.equal(a, b) for a, b in zip(*results))
    print(f"  one step run twice from the same state: parameters bitwise equal={same}",
          flush=True)
    check(same, f"{label}: two runs of one training step from the same state differ")


def lm_train_card(torch, timer):
    """18a: zamba2-7b at full width, 12 layers, bf16, B = 2 x 2048, remat:
    four AdamW steps through ``train_loop``'s default step, then four with
    two microbatches; ms a step, tokens/s, peak memory, busy share, the LM
    kernels' launches; one step run twice from one state, bitwise; and,
    at 2 layers, a run interrupted at step 2 and resumed from its
    checkpoint, bitwise an unbroken one.  Returns the first run's launches
    and, for 18e, its final parameters, losses and peak memory and the
    timed step's host wall and device ms."""
    import dataclasses
    import tempfile

    from repro_torch.configs import get_arch
    from repro_torch.core import prng
    from repro_torch.data import DataConfig, SyntheticTokens
    from repro_torch.kernels.flash_attention.flash_attention import (BWD_ROUTE_LAUNCHES,
                                                                     ROUTE_LAUNCHES)
    from repro_torch.models import ModelOptions, init_params
    from repro_torch.optim import adamw, cosine_schedule
    from repro_torch.train import make_accum_train_step

    cfg = dataclasses.replace(get_arch("zamba2-7b"), n_layers=LM_TRAIN_LAYERS)
    n_inv = -(-cfg.n_layers // cfg.shared_attn_every)
    tokens = LM_TRAIN_BATCH * LM_TRAIN_LEN
    start = time.perf_counter()
    params = init_params(cfg, prng.PRNGKey(0, device="cuda"), device="cuda")
    torch.cuda.synchronize()
    n_par = sum(p.numel() for p in params.parameters())
    par_gib = sum(p.numel() * p.element_size() for p in params.parameters()) / 2**30
    print(f"  zamba2-7b bf16, {cfg.n_layers} of 81 layers at full width (d_model "
          f"{cfg.d_model}, {cfg.n_heads} heads of {cfg.resolved_head_dim}, SSM state "
          f"{cfg.ssm_state}, d_ff {cfg.d_ff}): {n_par / 1e9:.3f} B parameters "
          f"({par_gib:.2f} GiB) drawn in {time.perf_counter() - start:.2f} s", flush=True)
    runs = {}
    for mb in (1, 2):
        if mb == 2:
            del params
            params = init_params(cfg, prng.PRNGKey(0, device="cuda"), device="cuda")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _zero_launches()
        ROUTE_LAUNCHES.update(dict.fromkeys(ROUTE_LAUNCHES, 0))
        BWD_ROUTE_LAUNCHES.update(dict.fromkeys(BWD_ROUTE_LAUNCHES, 0))
        out = _lm_train_run(torch, cfg, params, mb, LM_TRAIN_STEPS)
        torch.cuda.synchronize()
        launched = {k: v for k, v in _read_launches().items() if k in LM_KERNELS}
        peak = torch.cuda.max_memory_allocated()
        losses = [v for _, v in out["losses"]]
        per_step = out["wall_s"] / LM_TRAIN_STEPS
        print(f"  train_loop, default step, microbatches={mb}, {LM_TRAIN_STEPS} steps: "
              f"losses {', '.join(f'{v:.6f}' for v in losses)}; {per_step * 1e3:.1f} ms a "
              f"step over the run ({tokens / per_step:.0f} tokens/s, the first step's "
              f"warm-up included); peak device memory {peak / 2**30:.2f} GiB; launches "
              f"{launched}; flash_attention by route {dict(ROUTE_LAUNCHES)}, "
              f"flash_attention_bwd by route {dict(BWD_ROUTE_LAUNCHES)}", flush=True)
        check(len(losses) == LM_TRAIN_STEPS and all(np.isfinite(losses)),
              f"microbatches={mb}: the losses are not {LM_TRAIN_STEPS} finite values")
        # each step: every layer's forward twice (remat), its backward once
        want = {"flash_attention": 2 * mb * n_inv * LM_TRAIN_STEPS,
                "ssd_scan": 2 * mb * cfg.n_layers * LM_TRAIN_STEPS,
                "flash_attention_bwd": mb * n_inv * LM_TRAIN_STEPS,
                "ssd_scan_bwd": mb * cfg.n_layers * LM_TRAIN_STEPS}
        check(launched == want, f"microbatches={mb}: the LM kernels launched {launched}, "
              f"not {want}")
        check(ROUTE_LAUNCHES["wgmma"] == want["flash_attention"],
              f"the bf16 training forward's attention took the routes {ROUTE_LAUNCHES}")
        check(BWD_ROUTE_LAUNCHES["wgmma"] == want["flash_attention_bwd"],
              f"the bf16 training step's attention backward took the routes "
              f"{BWD_ROUTE_LAUNCHES}")
        runs[mb] = (launched, losses)
        if mb == 1:  # 18e's eager side
            eager = dict(params=[p.detach().clone() for p in out["params"].parameters()],
                         losses=losses, peak=peak)
        del out  # its optimizer state: 12.8 GB of AdamW moments
    first = runs[1][1][0], runs[2][1][0]
    print(f"  step 1's loss, microbatches 1 vs 2 (the same weights and tokens, split in "
          f"two): {first[0]:.6f} vs {first[1]:.6f}, {abs(first[0] - first[1]) / first[0]:.2e}"
          f" relative (bf16 products in other shapes; limit 1e-2)", flush=True)
    check(abs(first[0] - first[1]) <= 1e-2 * first[0], "microbatches change step 1's loss")
    main_launches = runs[1][0]

    # one more step, timed: host wall with a synchronize, device time profiled
    opt = adamw(cosine_schedule(3e-4, 10, LM_TRAIN_STEPS))
    step = make_accum_train_step(cfg, opt, ModelOptions(remat=True), 1)
    data = SyntheticTokens(DataConfig(LM_TRAIN_BATCH, LM_TRAIN_LEN, cfg.vocab))
    batch = {k: torch.as_tensor(v, device="cuda") for k, v in data.batch_at(0).items()}
    state = opt.init(list(params.parameters()))
    walls = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, state, _ = step(params, state, batch)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    wall = min(walls)
    totals = timer.kernels_us(lambda: step(params, state, batch), reps=1, flush=False,
                              warm=False)
    dev_ms = sum(t for t, _ in totals.values()) / 1e3
    n_kern = sum(n for _, n in totals.values())
    busy = "not measured" if dev_ms == 0 else f"{dev_ms / (wall * 1e3):.0%}"
    kinds = dict.fromkeys(("flash_attention", "flash_attention_bwd", "ssd_scan",
                           "ssd_scan_bwd", "GEMM", "other"), 0.0)
    for name, (us, _) in totals.items():
        low = name.lower()
        kind = ("flash_attention_bwd" if "flash_attention_bwd" in name else
                "flash_attention" if "flash_attention_kernel" in name else
                "ssd_scan_bwd" if "ssd_bwd_kernel" in name else
                "ssd_scan" if "ssd_scan_kernel" in name else
                "GEMM" if any(t in low for t in ("gemm", "nvjet", "xmma", "cutlass"))
                else "other")
        kinds[kind] += us / 1e3
    print(f"  one step (microbatches=1): host wall {', '.join(f'{w * 1e3:.1f}' for w in walls)}"
          f" ms ({tokens / wall:.0f} tokens/s); one profiled step {dev_ms:.2f} ms of device "
          f"time over {n_kern} kernels; device busy {busy} of the host wall; by kind: "
          + ", ".join(f"{k} {v:.2f} ms ({v / max(dev_ms, 1e-9):.0%})" for k, v in kinds.items()),
          flush=True)

    _step_twice_bitwise(torch, step, params, state, batch, "zamba2-7b")
    eager["ms"] = (wall * 1e3, dev_ms if dev_ms else None)
    del params, state, step, runs, batch
    torch.cuda.empty_cache()

    # resume: 2 layers at full width (a checkpoint of 12 layers with AdamW's
    # moments would be 16 GB)
    rcfg = dataclasses.replace(cfg, n_layers=LM_RESUME_LAYERS)
    fresh_params = lambda: init_params(rcfg, prng.PRNGKey(0, device="cuda"),  # noqa: E731
                                       device="cuda")
    unbroken = _lm_train_run(torch, rcfg, fresh_params(), 1, LM_TRAIN_STEPS)
    with tempfile.TemporaryDirectory() as d:
        start = time.perf_counter()
        _lm_train_run(torch, rcfg, fresh_params(), 1, 2, ckpt_dir=d, ckpt_every=2)
        with open(os.path.join(d, "step_00000002", "manifest.json")) as f:
            manifest = json.load(f)
        resumed = _lm_train_run(torch, rcfg, fresh_params(), 1, LM_TRAIN_STEPS, ckpt_dir=d)
        seconds = time.perf_counter() - start
    kinds = {}
    for leaf in manifest["leaves"]:
        kinds[leaf["dtype"]] = kinds.get(leaf["dtype"], 0) + 1
    same = all(torch.equal(a, b) for a, b in zip(unbroken["params"].parameters(),
                                                resumed["params"].parameters()))
    print(f"  {LM_RESUME_LAYERS} layers at full width: interrupted at step 2 and resumed "
          f"from its checkpoint ({seconds:.1f} s; leaves by dtype {kinds}): parameters "
          f"bitwise those of an unbroken run={same}; losses {resumed['losses']} vs "
          f"{unbroken['losses'][2:]}", flush=True)
    check(same and resumed["n_dispatches"] == LM_TRAIN_STEPS - 2,
          "the resumed run differs from the unbroken one")
    check(kinds.get("bfloat16", 0) > 0, "the checkpoint holds no bf16 leaf")
    return main_launches, eager


def _lm_step_launches(cfg, steps):
    """The LM kernels' launches of ``steps`` remat training steps of
    ``cfg`` (zamba2): each layer's forward twice, its backward once."""
    n_inv = -(-cfg.n_layers // cfg.shared_attn_every)
    return {"flash_attention": 2 * n_inv * steps, "ssd_scan": 2 * cfg.n_layers * steps,
            "flash_attention_bwd": n_inv * steps, "ssd_scan_bwd": cfg.n_layers * steps}


def _stacked_batches(torch, data, steps):
    """``data``'s batches of ``steps`` stacked leafwise on the card, as
    ``train_loop`` hands a chunk its batches."""
    batches = [data.batch_at(s) for s in steps]
    return {k: torch.as_tensor(np.stack([b[k] for b in batches]), device="cuda")
            for k in batches[0]}


def _graph_ms(torch, timer, fn, steps):
    """(host wall ms a step, device ms a step, its source) of ``fn``, a call
    that runs ``steps`` training steps: the wall up to the end of its device
    work, the device time from the profiler's kernels (or, where the
    profiler records none, CUDA events around the call)."""
    wall = _wall_s(torch, fn) * 1e3 / steps
    dev, _ = _device_ms(timer, fn)
    if dev is not None:
        return wall, dev / steps, "profiler"
    return wall, timer.event_ms(fn, reps=1, flush=False) / steps, "CUDA events"


def lm_train_graphed_card(torch, timer, eager):
    """18e: 18a's run (zamba2-7b at full width, bf16, 2 x 2048, remat,
    AdamW on its schedule, LM_TRAIN_STEPS steps of ``train_loop``'s default
    step from ``init_params(PRNGKey(0))``) again with ``steps_per_call`` =
    LM_GRAPH_K: one CUDA graph for the chunk length, since the step is
    marked capturable.  Its parameters and losses must be bitwise those of
    18a's eager run (``eager``); prints the capture seconds, ms a step of
    host wall and of device time of a replay against 18a's timed eager
    step, the peaks of both runs, and the LM kernels' launches (captured
    once, counted at each replay).  A capture that fails raises: nothing
    falls back to eager steps."""
    from repro_torch.configs import get_arch
    from repro_torch.core import prng
    from repro_torch.data import DataConfig, SyntheticTokens
    from repro_torch.models import init_params

    cfg = dataclasses.replace(get_arch("zamba2-7b"), n_layers=LM_TRAIN_LAYERS)
    params = init_params(cfg, prng.PRNGKey(0, device="cuda"), device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_launches()
    start = time.perf_counter()
    out = _lm_train_run(torch, cfg, params, 1, LM_TRAIN_STEPS, steps_per_call=LM_GRAPH_K)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    launched = {k: v for k, v in _read_launches().items() if k in LM_KERNELS}
    peak = torch.cuda.max_memory_allocated()
    graph = out["graphs"].get(LM_GRAPH_K)
    check(graph is not None, "18e: train_loop ran the LM step's chunks eagerly")
    losses = [v for _, v in out["losses"]]
    same_params = all(torch.equal(a, b) for a, b in zip(eager["params"],
                                                        out["params"].parameters()))
    data = SyntheticTokens(DataConfig(LM_TRAIN_BATCH, LM_TRAIN_LEN, cfg.vocab))
    chunk = _stacked_batches(torch, data, range(LM_GRAPH_K))
    state = (out["params"], out["opt_state"])
    wall, dev, source = _graph_ms(torch, timer, lambda: graph(state, chunk), LM_GRAPH_K)
    record = graph.record.by_kernel()
    one = _lm_step_launches(cfg, 1)
    n_chunks = -(-LM_TRAIN_STEPS // LM_GRAPH_K)
    want = {k: n * (n_chunks * LM_GRAPH_K + 1) for k, n in one.items()}  # + the warm-up
    want_rec = {k: n * LM_GRAPH_K for k, n in one.items()}
    e_wall, e_dev = eager["ms"]
    gib = 2**30
    print(f"  18e zamba2-7b bf16, {cfg.n_layers} of 81 layers, B={LM_TRAIN_BATCH} x "
          f"{LM_TRAIN_LEN}, remat, AdamW: 18a's train_loop run with K={LM_GRAPH_K}, graphed: "
          f"bitwise 18a's eager run: parameters {same_params}, losses "
          f"{losses == eager['losses']} ({', '.join(f'{v:.6f}' for v in losses)}); capture "
          f"{graph.capture_seconds:.2f} s (the warm-up step included); ms a step, host wall"
          f" / device: a replay {wall:.2f} / {dev:.2f} ({source}), 18a's timed eager step "
          f"{e_wall:.2f} / {e_dev if e_dev is None else round(e_dev, 2)} (profiler); peak "
          f"device memory graphed {peak / gib:.3f} GiB vs eager {eager['peak'] / gib:.3f}; "
          f"run wall {seconds:.1f} s; launches {launched} (captured a chunk {record}); card "
          f"{card_line()}", flush=True)
    check(same_params and losses == eager["losses"],
          "18e: the graphed chunks differ from 18a's eager steps")
    check(launched == want and record == want_rec,
          f"18e: the graphed run launched {launched} (captured {record}), not {want} "
          f"({want_rec})")
    del out, state, graph, params
    torch.cuda.empty_cache()
    return launched


def lm_grad_card(torch):
    """18b: zamba2-7b's width at 12 layers in float32, B = 1 x 512: the loss
    and its gradients (what ``make_train_step`` applies) on the kernel path
    against the plain path, from the same weights; then one
    ``make_train_step`` on the kernel path.

    Each gradient leaf is held within 1e-4 of the larger of its own max|.|
    and 1% of the largest leaf's, plus twice the leaf's own float32 noise:
    the distance between two plain-path runs that differ only in the SSD's
    chunk (64 against 128: the same function, summed in another order).
    ``ssd_operand_check`` then holds the SSD's backward kernel to the
    float64 twin on one layer's real operands."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.core import prng
    from repro_torch.models import ModelOptions, init_params, loss_fn, make_train_step
    from repro_torch.optim import adamw

    cfg = dataclasses.replace(get_arch("zamba2-7b"), n_layers=LM_TRAIN_LAYERS,
                              dtype="float32")
    params = init_params(cfg, prng.PRNGKey(0, device="cuda"), device="cuda")
    toks = _lm_tokens(torch, cfg, LM_GRAD_BATCH, LM_GRAD_LEN + 1, seed=18)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    leaves = list(params.parameters())
    runs = {}
    for label, opts in (("kernel", ModelOptions(remat=True)),
                        ("plain", ModelOptions(use_flash="never", remat=True)),
                        ("plain64", ModelOptions(use_flash="never", ssd_chunk=64))):
        _zero_launches()
        loss = loss_fn(cfg, params, batch, opts)
        grads = torch.autograd.grad(loss, leaves)
        torch.cuda.synchronize()
        runs[label] = (loss.item(), grads, dict(_read_launches()))
        del loss, grads
    (lk, gk, nk), (lp, gp, npl) = runs["kernel"], runs["plain"]
    g64 = runs["plain64"][1]
    top = max(b.abs().max().item() for b in gp)
    names = [n for n, _ in params.named_parameters()]
    rows = []
    for name, a, b, c in zip(names, gk, gp, g64):
        scale = max(b.abs().max().item(), 1e-2 * top)
        noise = (b - c).abs().max().item()
        err = (a - b).abs().max().item()
        rows.append((err / (LM_GRAD_REL * scale + 2 * noise), err / scale, noise / scale, name))
    rows.sort(reverse=True)
    print(f"  float32, {cfg.n_layers} layers, B={LM_GRAD_BATCH} x {LM_GRAD_LEN}: kernel path "
          f"(launches {nk}) vs plain path (launches {npl}): loss {lk:.8f} vs {lp:.8f}, "
          f"{abs(lk - lp) / abs(lp):.2e} relative (limit 1e-5); gradients: the median leaf "
          f"{sorted(r[1] for r in rows)[len(rows) // 2]:.2e} of its scale, the leaves "
          f"nearest their limit (limit {LM_GRAD_REL:g} of the scale + 2 x the plain "
          f"path's own chunk-64 vs chunk-128 distance):", flush=True)
    for ratio, err, noise, name in rows[:5]:
        print(f"    {name}: {err:.2e} of its scale, float32 noise {noise:.2e}; "
              f"{ratio:.3f} of its limit", flush=True)
    n_inv = -(-cfg.n_layers // cfg.shared_attn_every)
    check(all(nk.get(k, 0) > 0 for k in LM_KERNELS) and not npl,
          f"18b: the kernel path launched {nk}, the plain path {npl}")
    check(nk.get("flash_attention_bwd") == n_inv and nk.get("ssd_scan_bwd") == cfg.n_layers,
          f"18b: backward launches {nk}")
    ssd_operand_check(torch, cfg, params, batch)
    check(abs(lk - lp) <= 1e-5 * abs(lp), "18b: the kernel path's loss differs")
    check(rows[0][0] <= 1.0, "18b: a gradient of the kernel path differs")
    opt = adamw(3e-4)
    _, state, m = make_train_step(cfg, opt)(params, opt.init(leaves), batch)
    check(int(state.step) == 1 and bool(torch.isfinite(m["loss"])),
          "18b: make_train_step on the kernel path")
    del params, runs, gk, gp, g64, state, m
    torch.cuda.empty_cache()


def ssd_operand_check(torch, cfg, params, batch):
    """18b: one SSM layer's real operands (the last layer's, recorded from
    a kernel-path backward): the SSD's forward and backward on the card,
    the kernels and the float32 twins each against the float64 twins; the
    backward kernel within 3x the float32 twin's distance on every
    gradient."""
    from repro_torch.kernels import SSD_SCAN
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.kernels.ssd_scan.ref import ssd_bwd_ref, ssd_chunked_ref
    from repro_torch.kernels.ssd_scan.ssd_scan import launch as ssd_launch
    from repro_torch.kernels.ssd_scan.ssd_scan import ssd_scan
    from repro_torch.models import ModelOptions, loss_fn

    seen = {}
    kernel_bwd = ssd_ops.ssd_scan_bwd

    def record(x, dt, A, B, C, dy, *, chunk):
        seen.setdefault("args", [t.detach().clone() for t in (x, dt, A, B, C, dy)])
        seen["chunk"] = chunk
        return kernel_bwd(x, dt, A, B, C, dy, chunk=chunk)

    ssd_ops.ssd_scan_bwd = record
    try:
        loss = loss_fn(cfg, params, batch, ModelOptions())
        torch.autograd.grad(loss, list(params.parameters()))
    finally:
        ssd_ops.ssd_scan_bwd = kernel_bwd
    x, dt, A, B, C, dy = seen["args"]
    L = seen["chunk"]
    y = ssd_scan(x, dt, A, B, C, chunk=L)
    got = kernel_bwd(x, dt, A, B, C, dy, chunk=L)
    twin = ssd_bwd_ref(x, dt, A, B, C, dy, chunk=L)
    wide = [t.double() for t in (x, dt, A, B, C, dy)]
    exact = ssd_bwd_ref(*wide, chunk=L)
    y64 = ssd_chunked_ref(*wide[:5], chunk=L)[0]
    y32 = ssd_chunked_ref(x, dt, A, B, C, chunk=L)[0]

    def rel(a, b):
        return (a.double() - b).abs().max().item() / b.abs().max().item()

    # the forward kernel's chunk states (TF32 products) against float64 ones:
    # why the backward recomputes its own on the FMA units
    b, l, h, dh = x.shape
    nc = l // L
    tf32_states = ssd_launch(SSD_SCAN, x, dt, A, B, C, torch.empty_like(x), L)
    cum = torch.cumsum((wide[2] * wide[1]).reshape(b, nc, L, h), dim=2)
    inc = torch.einsum("bnsh,bnshd,bnsk->bnhdk", torch.exp(cum[:, :, -1:] - cum),
                       (wide[1][..., None] * wide[0]).reshape(b, nc, L, h, dh),
                       wide[3].reshape(b, nc, L, -1))
    S, states64 = torch.zeros_like(inc[:, 0]), []
    for n in range(nc):
        states64.append(S)
        S = torch.exp(cum[:, n, -1])[..., None, None] * S + inc[:, n]
    print(f"  the forward kernel's chunk states (TF32 products) vs float64: "
          f"{rel(tf32_states, torch.stack(states64, 1)):.2e} of max|S|", flush=True)
    lam = (A * dt).reshape(x.shape[0], -1, L, A.shape[0]).sum(2)
    print(f"  the last SSM layer's operands (A dt summed over a chunk: {lam.min().item():.1f} "
          f"to {lam.max().item():.2f}): y, kernel {rel(y, y64):.2e} and float32 twin "
          f"{rel(y32, y64):.2e} of max|y| from the float64 twin; dx, ddt, dA, dB, dC, "
          f"kernel {', '.join(f'{rel(a, b):.2e}' for a, b in zip(got, exact))}, float32 "
          f"twin {', '.join(f'{rel(a, b):.2e}' for a, b in zip(twin, exact))}", flush=True)
    worst = max(rel(a, b) / max(rel(t, b), 1e-7) for a, t, b in zip(got, twin, exact))
    print(f"  the forward kernel's y from the float64 twin on these operands: "
          f"{rel(y, y64):.3e} of max|y| (limit {SSD_Y_REL:g}, the reference's kernel "
          f"tolerance); the float32 twin's {rel(y32, y64):.3e}", flush=True)
    check(rel(y, y64) <= SSD_Y_REL, "18b: the forward ssd_scan's y is further from the "
          "float64 twin than the reference's kernel tolerance on the model's operands")
    check(worst <= 3.0, "18b: the backward kernel is further from the float64 twin than "
          "three times the float32 twin on the model's operands")
    ssd_logits_diagnostic(torch, cfg, batch)


def ssd_logits_diagnostic(torch, cfg, batch):
    """18b: the logits of one zamba2-7b SSM layer at full width (a 1-layer
    model: the shared attention block, then one Mamba2 layer) on the kernel
    path in float32 and on the plain path in float32, each against the same
    forward in float64 (the layer's projections, convolutions and SSD in
    float64; the norms and attention compute in float32 inside, as the model
    writes them; the logits are returned in float32)."""
    import copy
    import dataclasses

    from repro_torch.core import prng
    from repro_torch.kernels.ssd_scan.ref import ssd_chunked_ref
    from repro_torch.models import ModelOptions, forward, init_params
    from repro_torch.models import ssm as ssm_module

    cfg1 = dataclasses.replace(cfg, n_layers=1)
    params = init_params(cfg1, prng.PRNGKey(1, device="cuda"), device="cuda")
    toks = {"tokens": batch["tokens"]}
    kernel_ssd = ssm_module.ssd

    def ssd64(x, dt, A, B, C, *, chunk, use_kernel):
        wide = (t.double() for t in (x, dt, A, B, C))
        return ssd_chunked_ref(*wide, chunk=min(chunk, x.shape[1]))[0]

    with torch.no_grad():
        kernel, _ = forward(cfg1, params, toks, ModelOptions())
        plain, _ = forward(cfg1, params, toks, ModelOptions(use_flash="never"))
        wide = copy.deepcopy(params).double()
        ssm_module.ssd = ssd64
        try:
            exact, _ = forward(cfg1, wide, toks, ModelOptions(use_flash="never"))
        finally:
            ssm_module.ssd = kernel_ssd
    top = exact.double().abs().max().item()
    print(f"  logits of one zamba2-7b SSM layer at full width (1 layer: the shared "
          f"attention block and one Mamba2 layer, B={batch['tokens'].shape[0]} x "
          f"{batch['tokens'].shape[1]}) against the same forward in float64: kernel path "
          f"{(kernel.double() - exact.double()).abs().max().item() / top:.3e}, plain path "
          f"{(plain.double() - exact.double()).abs().max().item() / top:.3e} of "
          f"max|logit| ({top:.3f})", flush=True)
    del params, wide, kernel, plain, exact
    torch.cuda.empty_cache()


def ees_depth_card(torch):
    """18c: EES(2,5) over olmo-1b's residual depth (``attn_block`` +
    ``mlp_block`` as ``examples/train_lm_ees_residual.py``, from ``h =
    embed[tokens]``), full width, float32, B = 4 x 512, step 1: at 16 layers
    the reversible adjoint's gradients through the kernels against the same
    adjoint on the plain path and
    against the full adjoint's (the stated limits below), the reconstruction
    error of h0; and the peak device memory of a forward and backward above
    the parameters' and gradients' bytes at 4, 8 and 16 layers (the gate:
    reversible flat, full growing)."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.core import prng
    from repro_torch.models import ModelOptions, init_params
    from repro_torch.models.layers import attn_block, mlp_block
    from repro_torch.models.reversible import _ees_step, ees_depth_solve

    cfg = dataclasses.replace(get_arch("olmo-1b"), dtype="float32", n_layers=EES_DEPTHS[-1])
    params = init_params(cfg, prng.PRNGKey(0, device="cuda"), device="cuda")

    def block(opts):
        def block_fn(lp, h):
            a = attn_block(cfg, lp["attn"], h, opts)
            return a + mlp_block(cfg, lp["mlp"], h + a, opts)
        return block_fn

    kernel_block, plain_block = block(ModelOptions()), block(ModelOptions(use_flash="never"))
    toks = _lm_tokens(torch, cfg, EES_BATCH, EES_LEN, seed=19)
    with torch.no_grad():
        h0 = params.embed[toks].clone()
    ct = torch.randn(h0.shape, device="cuda",
                     generator=torch.Generator(device="cuda").manual_seed(19))

    def grads(n, adjoint, block_fn=kernel_block):
        layers = params.layers[:n]
        y = ees_depth_solve(block_fn, layers, h0, step=1.0, adjoint=adjoint)
        return torch.autograd.grad(y, list(layers.parameters()), ct)

    def gaps(got, want):
        # each leaf against the larger of its own max|.| and 1% of the
        # largest leaf's (as 18b)
        top = max(b.abs().max().item() for b in want)
        per_leaf = [(a - b).abs().max().item() / max(b.abs().max().item(), 1e-2 * top)
                    for a, b in zip(got, want)]
        whole = (sum(((a - b) ** 2).sum() for a, b in zip(got, want)).sqrt()
                 / sum((b ** 2).sum() for b in want).sqrt()).item()
        return max(per_leaf), sorted(per_leaf)[len(per_leaf) // 2], whole

    n = EES_DEPTHS[-1]
    _zero_launches()
    g_rev = grads(n, "reversible")
    launched = dict(_read_launches())
    g_plain = grads(n, "reversible", plain_block)
    kp = gaps(g_rev, g_plain)
    del g_plain
    g_full = grads(n, "full")
    rf = gaps(g_rev, g_full)
    del g_full
    with torch.no_grad():
        y, f0 = h0, kernel_block(params.layers[0], h0)
        for lp in params.layers:
            y = _ees_step(kernel_block, lp, y, 1.0)
        for lp in reversed(params.layers):
            y = _ees_step(kernel_block, lp, y, -1.0)
        recon = ((y - h0).norm() / h0.norm()).item()
        f_ratio = (f0.norm() / h0.norm()).item()
    print(f"  olmo-1b block, float32, full width (d_model {cfg.d_model}, {cfg.n_heads} "
          f"heads, d_ff {cfg.d_ff}), B={EES_BATCH} x {EES_LEN}, {n} layers, step 1; the "
          f"reversible run launched {launched}", flush=True)
    print(f"  reversible gradients, kernel path vs plain path: worst leaf {kp[0]:.3e} of its "
          f"scale, median {kp[1]:.3e}, whole gradient {kp[2]:.3e} (limit {EES_KERNEL_REL:g} "
          f"a leaf)", flush=True)
    print(f"  reversible vs full adjoint gradients: worst leaf {rf[0]:.3e} of its max|.|, "
          f"median {rf[1]:.3e}, whole gradient {rf[2]:.3e} (limit {EES_GRAD_GAP:g} on the "
          f"whole gradient); |F(h0)| / |h0| = {f_ratio:.2f}, and h0 rebuilt through "
          f"{n} inverse steps is off by {recon:.3e} of |h0|", flush=True)
    check(kp[0] <= EES_KERNEL_REL,
          "18c: the reversible gradients differ between kernel and plain path")
    check(rf[2] <= EES_GRAD_GAP and all(bool(torch.isfinite(g).all()) for g in g_rev),
          "18c: the reversible adjoint's gradients are further from the full adjoint's "
          "than stated")
    check(launched.get("flash_attention", 0) > 0 and launched.get("flash_attention_bwd", 0) > 0,
          f"18c: the depth solve did not run the attention kernels: {launched}")
    del g_rev
    peaks = {}
    for adjoint in ("reversible", "full"):
        for depth in EES_DEPTHS:
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            g = grads(depth, adjoint)
            torch.cuda.synchronize()
            grad_bytes = sum(t.numel() * t.element_size() for t in g)
            peaks[adjoint, depth] = (torch.cuda.max_memory_allocated() - base
                                     - grad_bytes) / 2**20
            del g
    for adjoint in ("reversible", "full"):
        print(f"  {adjoint}: peak device memory above the parameters and gradients at "
              + ", ".join(f"{d} layers {peaks[adjoint, d]:.1f} MiB" for d in EES_DEPTHS),
              flush=True)
    lo, hi = EES_DEPTHS[0], EES_DEPTHS[-1]
    growth = peaks["reversible", hi] / peaks["reversible", lo] - 1
    ratio = peaks["full", hi] / peaks["full", lo]
    print(f"  from {lo} to {hi} layers: reversible grows {growth:.1%} (gate: under 10%), "
          f"full {ratio:.2f}x (gate: at least 3x)", flush=True)
    check(growth < 0.10, "18c: the reversible adjoint's memory grows with depth")
    check(ratio >= 3, "18c: the full adjoint's memory does not grow with depth")
    del params, h0, ct
    torch.cuda.empty_cache()


def launcher_card(torch):
    """18d: ``python -m repro_torch.launch.train --arch zamba2-7b --steps 4``
    (the reference's smoke config) as a subprocess on the card."""
    start = time.perf_counter()
    env = dict(os.environ, PYTHONPATH=SRC)
    proc = subprocess.run([sys.executable, "-m", "repro_torch.launch.train", "--arch",
                           "zamba2-7b", "--steps", str(LM_TRAIN_STEPS)], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=600)
    lines = proc.stdout.strip().splitlines()
    losses = [float(line.split()[-1]) for line in lines if line.startswith("step ")]
    print(f"  python -m repro_torch.launch.train --arch zamba2-7b --steps {LM_TRAIN_STEPS}: "
          f"exit {proc.returncode} in {time.perf_counter() - start:.1f} s; "
          + " | ".join(lines), flush=True)
    check(proc.returncode == 0, f"the launcher failed: {proc.stderr[-2000:]}")
    check(len(losses) == LM_TRAIN_STEPS and all(np.isfinite(losses)),
          "the launcher did not print its losses")


def lm_training_phase(torch, timer):
    """Phase 18: LM training at full width; returns 18a's launches."""
    launches, eager = {}, {}

    def train_card():
        got, ref = lm_train_card(torch, timer)
        launches.update(got)
        eager.update(ref)

    for label, fn in (("18a", train_card),
                      ("18b", lambda: lm_grad_card(torch)),
                      ("18c", lambda: ees_depth_card(torch)),
                      ("18d", lambda: launcher_card(torch)),
                      ("18e", lambda: lm_train_graphed_card(torch, timer, eager))):
        start = time.perf_counter()
        print(f" {label}", flush=True)
        fn()
        print(f"  ({label}: {time.perf_counter() - start:.1f} s)", flush=True)
        if label == "18e":
            eager.clear()  # its parameters
    return launches


# ---------------------------------------------------------------------------
# Phase 19: the moe family and the patch / frames frontends at full width.
# ---------------------------------------------------------------------------

# (arch, layers for prefill and decode, layers for training): the published
# widths; depth cut only where the card's 80 GB or the run's time forces it.
# olmoe-1b-7b's 16 layers are 13.8 GB of bf16 weights; its training at 4
# layers (1.89 B parameters) peaks near 47 GB at phase 18a's ~25 bytes a
# parameter (bf16 weights and gradients, float32 AdamW moments, remat).
# qwen3-moe-30b-a3b's 48 layers would put 61 GB of weights on the card
# before activations: 12 (8.1 B parameters) serve, 2 train (1.87 B).
MOE_ARCHS = (("olmoe-1b-7b", 16, 4), ("qwen3-moe-30b-a3b", 12, 2))
# (arch, layers for the forward, layers for training): uncut.
FRONTEND_ARCHS = (("qwen2-vl-2b", 28, 28), ("hubert-xlarge", 48, 48))
P19_STEPS = 4                  # AdamW steps of train_loop's default step (moe)
P19_CHECK_LAYERS = 2           # the float32 kernel-vs-plain and decode checks
P19_CHECK_BATCH, P19_CHECK_LEN = 2, 256
P19_DECODE_LEN = 16
P19_LOGIT_REL = 1e-4           # kernel path vs plain path, of max|logit| (11a, 18b)
P19_DECODE_ATOL = 2e-5         # decode vs forward (the reference's test)
P19_FLIP_SHARE = 0.01          # tokens whose expert set differs in some layer
P19_CAPACITY = 64.0            # dropless capacity for the checks
P19_SERVE = (8, 8, 32)         # Engine: requests, prompt tokens, max_len


def _p19_kinds(totals):
    """Device ms by kind of a profile: attention (forward, backward), GEMMs,
    the MoE dispatch and combine (sorts, searches, gathers, concatenations)
    and the rest."""
    kinds = dict.fromkeys(("flash_attention", "flash_attention_bwd", "GEMM",
                           "dispatch/combine", "other"), 0.0)
    for name, (us, _) in totals.items():
        low = name.lower()
        kind = ("flash_attention_bwd" if "flash_attention_bwd" in name else
                "flash_attention" if "flash_attention_kernel" in name else
                "GEMM" if any(t in low for t in ("gemm", "nvjet", "xmma", "cutlass")) else
                "dispatch/combine" if any(t in low for t in (
                    "sort", "radix", "search", "gather", "catarray", "scatter", "index"))
                else "other")
        kinds[kind] += us / 1e3
    return kinds


def _p19_print_profile(label, totals, wall_ms):
    kinds = _p19_kinds(totals)
    dev = sum(kinds.values())
    busy = "not measured" if dev == 0 else f"{dev / wall_ms:.0%}"
    print(f"  {label}: {dev:.2f} ms of device time over "
          f"{sum(n for _, n in totals.values())} kernels in {wall_ms:.1f} ms of host "
          f"wall (device busy {busy}); by kind: "
          + ", ".join(f"{k} {v:.2f} ms ({v / max(dev, 1e-9):.0%})" for k, v in kinds.items()),
          flush=True)
    return kinds


def _p19_batch(torch, cfg, b, s, seed):
    """Tokens and labels, with ``vision_embeds`` (patch) or ``frames`` in
    place of the tokens (frames), in the model's dtype, as the reference's
    smoke test builds them."""
    from repro_torch.models.common import dtype_of

    dtype = dtype_of(cfg.dtype)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    rng = np.random.default_rng(seed)
    toks = lambda: torch.from_numpy(rng.integers(0, cfg.vocab, size=(b, s))).cuda()  # noqa: E731
    batch = {"tokens": toks(), "labels": toks()}
    if cfg.frontend == "patch":
        batch["vision_embeds"] = torch.randn(b, cfg.n_vision_tokens, cfg.frontend_dim,
                                             generator=gen, device="cuda").to(dtype)
    if cfg.frontend == "frames":
        batch = {"frames": torch.randn(b, s, cfg.frontend_dim, generator=gen,
                                       device="cuda").to(dtype),
                 "labels": batch["labels"]}
    return batch


class _ExpertSets:
    """Records the top-k expert indices of every moe_block call (the module's
    ``top_k``, wrapped), per call in order."""

    def __init__(self, moe_mod):
        self.moe, self.calls = moe_mod, []

    def __enter__(self):
        self.inner = self.moe.top_k

        def recorded(probs, k):
            vals, idx = self.inner(probs, k)
            self.calls.append(idx.sort(dim=-1).values)
            return vals, idx

        self.moe.top_k = recorded
        return self

    def __exit__(self, *exc):
        self.moe.top_k = self.inner
        return False


def _split_row_products(torch, weights, parts):
    """A mode under which each ``x @ w`` with ``w`` among ``weights`` runs
    as a (1, ``parts``) mesh runs a row-parallel product: a partial product
    for each block of w's rows (x's last dim split alike), each rounded to
    the product's dtype, summed in that dtype in rank order, as the
    all-reduce of the partial sums adds them.  One rank then carries the
    mesh's rounding (21b's witness)."""
    from torch.overrides import TorchFunctionMode

    ids = {id(w) for w in weights}

    class SplitRowProducts(TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            if (getattr(func, "__name__", "") in ("matmul", "__matmul__") and len(args) == 2
                    and id(args[1]) in ids):
                x, w = args
                n = w.shape[0] // parts
                out = x[..., :n] @ w[:n]
                for i in range(1, parts):
                    out = out + x[..., i * n:(i + 1) * n] @ w[i * n:(i + 1) * n]
                return out
            return func(*args, **(kwargs or {}))

    return SplitRowProducts()


def _flip_err(torch, got, want, sets_got, sets_want, vocab, rel=True):
    """Logits ``got`` against ``want`` (B, S, V) on the tokens before each
    sequence's first token whose expert set differs in any layer (causal
    attention carries a flip to every later token): (tokens with a flip,
    tokens kept, max |diff| there, of max|want| when ``rel``).  Only the
    first ``vocab`` columns are compared: the pad columns hold -1e9."""
    b, s = got.shape[:2]
    got, want = got[..., :vocab], want[..., :vocab]
    flips = torch.zeros(b, s, dtype=torch.bool, device=got.device)
    for a, w in zip(sets_got, sets_want):
        flips |= (a != w).any(-1).reshape(b, s)
    first = torch.where(flips.any(1), flips.float().argmax(1),
                        torch.full((b,), s, dtype=torch.long, device=got.device))
    keep = torch.arange(s, device=got.device)[None] < first[:, None]
    n_flip, n_keep = int(flips.sum()), int(keep.sum())
    scale = want.abs().max().item() if rel else 1.0
    err = ((got - want).abs()[keep].max().item() / scale) if n_keep else 0.0
    return n_flip, n_keep, err


def _p19_compare(torch, label, got, want, sets_got, sets_want, limit, vocab, rel=True):
    """:func:`_flip_err`, printed and gated."""
    b, s = got.shape[:2]
    n_flip, n_keep, err = _flip_err(torch, got, want, sets_got, sets_want, vocab, rel)
    share = n_flip / (b * s)
    print(f"  {label}: {n_flip} of {b * s} tokens route to another expert set in some "
          f"layer ({share:.2%}; limit {P19_FLIP_SHARE:.0%}); on the {n_keep} tokens before "
          f"each sequence's first such token, max |diff| {err:.3e}"
          f"{' of max|logit|' if rel else ''} (limit {limit:g})", flush=True)
    check(share <= P19_FLIP_SHARE and err <= limit and n_keep > 0,
          f"{label}: outside its limits")


def _p19_checks(torch, arch):
    """The float32 checks at P19_CHECK_LAYERS layers, full width: the kernel
    path against the plain path, and (decoders) token-by-token serve_step
    against the forward, moe at dropless capacity."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.core import prng
    from repro_torch.models import ModelOptions, forward, init_cache, init_params, moe, serve_step

    cfg = dataclasses.replace(get_arch(arch), n_layers=P19_CHECK_LAYERS, dtype="float32",
                              capacity_factor=P19_CAPACITY)
    params = init_params(cfg, prng.PRNGKey(1, device="cuda"), device="cuda")
    batch = _p19_batch(torch, cfg, P19_CHECK_BATCH, P19_CHECK_LEN, 191)
    runs = {}
    with torch.no_grad():
        for path, opts in (("kernel", ModelOptions()), ("plain", ModelOptions(use_flash="never"))):
            with _ExpertSets(moe) as rec:
                runs[path] = (forward(cfg, params, batch, opts)[0], rec.calls)
        _p19_compare(torch, f"{arch} float32, {cfg.n_layers} layers, B={P19_CHECK_BATCH} x "
                     f"{P19_CHECK_LEN}: kernel path vs plain path", runs["kernel"][0],
                     runs["plain"][0], runs["kernel"][1], runs["plain"][1], P19_LOGIT_REL,
                     cfg.vocab)
        if not cfg.supports_decode:
            return
        toks = batch["tokens"][:, :P19_DECODE_LEN]
        with _ExpertSets(moe) as rec:
            full = forward(cfg, params, {"tokens": toks})[0]
        cache = init_cache(cfg, P19_CHECK_BATCH, P19_DECODE_LEN, device="cuda")
        steps = []
        with _ExpertSets(moe) as dec:
            for i in range(P19_DECODE_LEN):
                steps.append(serve_step(cfg, params, cache, toks[:, i], i)[0])
        # decode routes one token a call: regroup its sets as (B, S) per layer
        per_layer = [torch.cat(dec.calls[layer::cfg.n_layers], dim=1)
                     for layer in range(len(rec.calls))]
        _p19_compare(torch, f"{arch} float32: decode ({P19_DECODE_LEN} tokens, "
                     f"serve_step) vs forward", torch.stack(steps, dim=1), full,
                     per_layer, rec.calls, P19_DECODE_ATOL, cfg.vocab, rel=False)


def _p19_engine(torch, cfg, params):
    """The decode Engine: requests of prompt tokens, greedy; tokens/s, ticks,
    finite logits, and the same tokens from a second drain."""
    n_req, n_prompt, max_len = P19_SERVE
    prompts = np.random.default_rng(19).integers(2, cfg.vocab, size=(n_req, n_prompt)).tolist()
    first, wall, ticks, finite, _ = _engine_drain(torch, cfg, params, prompts, max_len)
    second = _engine_drain(torch, cfg, params, prompts, max_len)[0]
    new = sum(len(t) - len(p) for t, p in zip(first.values(), prompts))
    print(f"  Engine(slots={n_req}, max_len={max_len}), {n_req} requests x {n_prompt}-token "
          f"prompts, greedy: {new} new tokens in {ticks} ticks, {wall:.3f} s = "
          f"{new / wall:.1f} tokens/s ({wall / ticks * 1e3:.1f} ms a tick); logits finite: "
          f"{finite}; a second drain gives the same tokens: {second == first}", flush=True)
    check(finite and len(first) == n_req and second == first,
          f"{cfg.name}: the decode engine's drains are not finite or differ")


def _p19_prefill(torch, timer, cfg, params, batch, launches):
    """One forward of ``batch`` (head_positions='last' where there is a
    decoder): launches by route, peak memory, ms, tokens/s, busy share."""
    from repro_torch.kernels import FLASH_ATTENTION
    from repro_torch.kernels.flash_attention.flash_attention import ROUTE_LAUNCHES
    from repro_torch.models import forward

    b, s = batch["labels"].shape
    head = "last" if cfg.supports_decode else "all"

    def run():
        return forward(cfg, params, batch, head_positions=head)[0]

    with torch.no_grad():
        run()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        FLASH_ATTENTION.launches = 0
        ROUTE_LAUNCHES.update(dict.fromkeys(ROUTE_LAUNCHES, 0))
        logits = run()
        torch.cuda.synchronize()
        routes, peak = dict(ROUTE_LAUNCHES), torch.cuda.max_memory_allocated()
        launches["flash_attention"] += FLASH_ATTENTION.launches
        check(bool(torch.isfinite(logits).all())
              and logits.shape == (b, 1 if head == "last" else s, cfg.padded_vocab),
              f"{cfg.name}: the forward's logits are not finite of the right shape")
        check(routes == {"wgmma": cfg.n_layers, "mma_tf32": 0, "simt": 0},
              f"{cfg.name}: the forward's attention took the routes {routes}")
        walls = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        wall = sorted(walls)[1]
        print(f"  forward B={b} x {s} (head_positions='{head}'): "
              f"{', '.join(f'{w * 1e3:.1f}' for w in walls)} ms, median {wall * 1e3:.1f} ms "
              f"= {b * s / wall:.0f} tokens/s; peak device memory {peak / 2**30:.2f} GiB; "
              f"flash_attention by route {routes}", flush=True)
        _p19_print_profile("one profiled forward",
                           timer.kernels_us(run, reps=1, flush=False), wall * 1e3)


def _p19_train_profile(torch, timer, cfg, params, batch, launches, steps_done):
    """One more step of ``make_train_step``, timed and profiled, then one
    step run twice from one state (bitwise)."""
    from repro_torch.models import ModelOptions, make_train_step
    from repro_torch.optim import adamw

    b, s = batch["labels"].shape
    opt = adamw(3e-4)
    step = make_train_step(cfg, opt, ModelOptions(remat=True))
    state = opt.init(list(params.parameters()))
    walls = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, state, metrics = step(params, state, batch)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    check(bool(torch.isfinite(metrics["loss"])), f"{cfg.name}: non-finite training loss")
    wall = min(walls)
    print(f"  make_train_step (remat, AdamW): host wall "
          f"{', '.join(f'{w * 1e3:.1f}' for w in walls)} ms ({b * s / wall:.0f} tokens/s), "
          f"loss {float(metrics['loss']):.6f}{steps_done}", flush=True)
    _p19_print_profile("one profiled step", timer.kernels_us(
        lambda: step(params, state, batch), reps=1, flush=False, warm=False), wall * 1e3)
    _step_twice_bitwise(torch, step, params, state, batch, cfg.name)


def _p19_counted_step(torch, cfg, run, launches):
    """Runs ``run`` (training steps) with the attention launches counted:
    every forward and backward on the wgmma route."""
    from repro_torch.kernels import FLASH_ATTENTION, FLASH_ATTENTION_BWD
    from repro_torch.kernels.flash_attention.flash_attention import (BWD_ROUTE_LAUNCHES,
                                                                     ROUTE_LAUNCHES)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    FLASH_ATTENTION.launches = FLASH_ATTENTION_BWD.launches = 0
    ROUTE_LAUNCHES.update(dict.fromkeys(ROUTE_LAUNCHES, 0))
    BWD_ROUTE_LAUNCHES.update(dict.fromkeys(BWD_ROUTE_LAUNCHES, 0))
    out = run()
    torch.cuda.synchronize()
    fwd, bwd = dict(ROUTE_LAUNCHES), dict(BWD_ROUTE_LAUNCHES)
    launches["flash_attention"] += FLASH_ATTENTION.launches
    launches["flash_attention_bwd"] += FLASH_ATTENTION_BWD.launches
    check(FLASH_ATTENTION.launches > 0 and fwd["wgmma"] == FLASH_ATTENTION.launches
          and FLASH_ATTENTION_BWD.launches > 0
          and bwd["wgmma"] == FLASH_ATTENTION_BWD.launches,
          f"{cfg.name}: the training step's attention took the routes {fwd} / {bwd}")
    return out, fwd, bwd, torch.cuda.max_memory_allocated()


def _p19_moe(torch, timer, arch, layers, train_layers, launches):
    """19a / 19b: a moe arch in bf16 at full width."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.core import prng
    from repro_torch.models import LMParams, init_params, moe

    full = get_arch(arch)
    cfg = dataclasses.replace(full, n_layers=layers)
    start = time.perf_counter()
    params = init_params(cfg, prng.PRNGKey(0, device="cuda"), device="cuda")
    torch.cuda.synchronize()
    n_par = sum(p.numel() for p in params.parameters())
    print(f"  {arch} bf16, {layers} of {full.n_layers} layers at full width (d_model "
          f"{cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads of {cfg.resolved_head_dim}, "
          f"{cfg.n_experts} experts top-{cfg.moe_top_k} of d_ff {cfg.moe_d_ff}): "
          f"{n_par / 1e9:.3f} B parameters ({torch.cuda.memory_allocated() / 2**30:.2f} GiB "
          f"allocated) drawn in {time.perf_counter() - start:.2f} s", flush=True)
    batch = _p19_batch(torch, cfg, PREFILL_BATCH, PREFILL_LEN, 19)
    _p19_prefill(torch, timer, cfg, params, batch, launches)
    # one layer's moe_block at the prefill's shape: where its time goes
    h = torch.randn(PREFILL_BATCH, PREFILL_LEN, cfg.d_model, device="cuda",
                    dtype=params.embed.dtype)
    with torch.no_grad():
        blk = lambda: moe.moe_block(cfg, params.layers[0]["moe"], h)  # noqa: E731
        blk()
        walls = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            blk()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        _p19_print_profile(f"one layer's moe_block (B={PREFILL_BATCH} x {PREFILL_LEN}, "
                           f"grouped, capacity {moe._capacity(cfg, PREFILL_LEN)} a "
                           f"sequence)", timer.kernels_us(blk, reps=1, flush=False),
                           sorted(walls)[1] * 1e3)
    del h
    _p19_engine(torch, cfg, params)
    # training at train_layers: the first layers of the same weights
    params = LMParams(params.embed.data, list(params.layers[:train_layers]),
                      final_norm=params.final_norm.data,
                      lm_head=params.get("lm_head").data if params.get("lm_head") is not None
                      else None)
    torch.cuda.empty_cache()
    tcfg = dataclasses.replace(cfg, n_layers=train_layers)
    n_par = sum(p.numel() for p in params.parameters())
    out, fwd, bwd, peak = _p19_counted_step(
        torch, tcfg, lambda: _lm_train_run(torch, tcfg, params, 1, P19_STEPS), launches)
    losses = [v for _, v in out["losses"]]
    per_step = out["wall_s"] / P19_STEPS
    print(f"  train_loop, default step, {train_layers} layers ({n_par / 1e9:.3f} B "
          f"parameters), B={LM_TRAIN_BATCH} x {LM_TRAIN_LEN}, remat, {P19_STEPS} AdamW steps: "
          f"losses {', '.join(f'{v:.6f}' for v in losses)}; {per_step * 1e3:.1f} ms a step "
          f"over the run ({LM_TRAIN_BATCH * LM_TRAIN_LEN / per_step:.0f} tokens/s, warm-up "
          f"included); peak device memory {peak / 2**30:.2f} GiB; flash_attention by route "
          f"{fwd}, flash_attention_bwd by route {bwd}", flush=True)
    check(len(losses) == P19_STEPS and all(np.isfinite(losses)),
          f"{arch}: the training losses are not {P19_STEPS} finite values")
    del out
    torch.cuda.empty_cache()
    tbatch = _p19_batch(torch, tcfg, LM_TRAIN_BATCH, LM_TRAIN_LEN, 20)
    _p19_train_profile(torch, timer, tcfg, params, tbatch, launches, "")
    del params, tbatch
    torch.cuda.empty_cache()


def _p19_frontend(torch, timer, arch, layers, train_layers, launches):
    """19c / 19d: a frontend arch in bf16 at full width: a forward of its
    inputs, one training step, and (hubert) the Engine's refusal."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.core import prng
    from repro_torch.models import ModelOptions, init_params, make_train_step
    from repro_torch.optim import adamw
    from repro_torch.serving import Engine

    full = get_arch(arch)
    cfg = dataclasses.replace(full, n_layers=layers)
    params = init_params(cfg, prng.PRNGKey(0, device="cuda"), device="cuda")
    n_par = sum(p.numel() for p in params.parameters())
    extra = (f"{cfg.n_vision_tokens} vision tokens of {cfg.frontend_dim}"
             if cfg.frontend == "patch" else f"frames of {cfg.frontend_dim}")
    print(f"  {arch} bf16, {layers} of {full.n_layers} layers at full width (d_model "
          f"{cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads of {cfg.resolved_head_dim}, "
          f"{'causal' if cfg.causal else 'non-causal'}, {extra}): {n_par / 1e9:.3f} B "
          f"parameters", flush=True)
    batch = _p19_batch(torch, cfg, PREFILL_BATCH, PREFILL_LEN, 21)
    _p19_prefill(torch, timer, cfg, params, batch, launches)
    if not cfg.supports_decode:
        try:
            Engine(cfg, params)
        except ValueError as exc:
            print(f"  Engine({arch}): ValueError({exc})", flush=True)
            check(str(exc) == f"{cfg.name} is encoder-only: no decode",
                  "the refusal differs from the reference's")
        else:
            fail(f"the decode Engine accepted the encoder-only {arch}")
    opt = adamw(3e-4)
    step = make_train_step(cfg, opt, ModelOptions(remat=True))
    state = opt.init(list(params.parameters()))
    _, fwd, bwd, peak = _p19_counted_step(
        torch, cfg, lambda: step(params, state, batch), launches)
    print(f"  one counted training step ({layers} layers, B={PREFILL_BATCH} x "
          f"{PREFILL_LEN}, remat, AdamW): peak device memory {peak / 2**30:.2f} GiB; "
          f"flash_attention by route {fwd}, flash_attention_bwd by route {bwd}", flush=True)
    del state
    torch.cuda.empty_cache()
    _p19_train_profile(torch, timer, cfg, params, batch, launches,
                       " (after one counted step)")
    del params, batch
    torch.cuda.empty_cache()


def moe_frontend_phase(torch, timer):
    """Phase 19; returns the attention kernels' launches over its paths."""
    launches = {"flash_attention": 0, "flash_attention_bwd": 0}
    cuts = []
    for arch, layers, train_layers in MOE_ARCHS + FRONTEND_ARCHS:
        cuts.append(f"{arch}: {layers} layers served, {train_layers} trained")
    print(f"  depths: {'; '.join(cuts)}; float32 checks at {P19_CHECK_LAYERS} layers",
          flush=True)
    for i, (arch, layers, train_layers) in enumerate(MOE_ARCHS + FRONTEND_ARCHS):
        start = time.perf_counter()
        tag = "19" + "abcd"[i]
        print(f" {tag}: {arch}", flush=True)
        _p19_checks(torch, arch)
        torch.cuda.empty_cache()
        if (arch, layers, train_layers) in MOE_ARCHS:
            _p19_moe(torch, timer, arch, layers, train_layers, launches)
        else:
            _p19_frontend(torch, timer, arch, layers, train_layers, launches)
        print(f"  ({tag}: {time.perf_counter() - start:.1f} s)", flush=True)
    return launches


# Phase 20: mesh data parallelism on a world of one NCCL rank (20a, 20b),
# then two processes on the one card over gloo's CUDA collectives (20c:
# NCCL refuses two ranks on one device).
MEASURED = {}                # numbers of earlier phases phase 20 prints beside its own
MESH_TRAIN_STEPS = 3
MESH_WORKERS = 2


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _host_same(got, want) -> bool:
    """Two sync drains' host results bitwise equal."""
    return all((getattr(got, f) is None) == (getattr(want, f) is None)
               and (getattr(got, f) is None or np.array_equal(getattr(got, f),
                                                               getattr(want, f)))
               for f in ("y_final", "ys", "diverged"))


class _LastGradient:
    """An optimizer whose state is the last gradient it was given (the
    parameters move by 1e-2 of it), so a step returns its gradient."""

    @staticmethod
    def init(params):
        return [p.detach().clone().zero_() for p in params]

    @staticmethod
    def update(grads, state, params):
        return ([p - 1e-2 * g for p, g in zip(params, grads)],
                [g.clone() for g in grads], grads[0].new_zeros(()))


def _ees_table1():
    from repro_torch.benchmarks import table1_ou as t1

    return next(s for s in t1.solvers() if s[1].startswith("ees25"))


def _mesh_serve_a(torch, mesh, slots):
    """Request A through an engine whose slots are sharded over ``mesh``."""
    from repro_torch.nsde import init_lsde, lsde_term
    from repro_torch.serving import SDESampleConfig, SDESampleEngine

    params = init_lsde(0, D_OBS, D_Z, WIDTH, device="cuda")
    with torch.no_grad():
        y0 = torch.zeros(D_Z, device="cuda") + params.encoder.b
    engine = SDESampleEngine(lsde_term(), y0, SDESampleConfig(
        slots=slots, ticks_per_dispatch=2, mesh=mesh, mesh_axis="mc"), args=params,
        device="cuda")
    spec, t1_, n, n_paths, save_every, seed = ABC[0]
    rid = engine.submit(spec, t1=t1_, n_steps=n, n_paths=n_paths, save_every=save_every,
                        seed=seed)
    return engine.run()[rid], engine.executor.graphed


def _mesh_grad(torch, mesh=None):
    """One Table-1 EES(2,5) step's loss and gradient (kernels, reversible
    adjoint), its optimizer the last-gradient one."""
    _, spec, n_steps = _ees_table1()
    kw = {} if mesh is None else {"mesh": mesh, "mesh_axis": "dp"}
    step, _, params, state, key = _lsde_step(
        torch, spec, "cuda", n_steps=n_steps, save_every=n_steps // 2,
        adjoint="reversible", optimizer=_LastGradient(), **kw)
    _, grads, m = step(params, state, key)
    return m["loss"], grads


def mesh_worker(rank: int, port: int, out: str) -> None:
    """A phase-20c rank (its own process): a gloo world of MESH_WORKERS on
    the one card; serves request A with sharded slots, takes one Table-1
    step on the train mesh and, on rank 0, the same step's two blocks in
    turn (their partials), saved to ``out``."""
    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_sample_mesh, make_train_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)  # both ranks share the one card
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=MESH_WORKERS)
    try:
        a, graphed = _mesh_serve_a(torch, make_sample_mesh(), SERVE_SLOTS)
        loss, grads = _mesh_grad(torch, make_train_mesh())
        got = {"a": {f: getattr(a, f) for f in ("y_final", "ys", "diverged")},
               "graphed": graphed,
               "loss": loss.cpu(), "grads": [g.cpu() for g in grads]}
        if rank == 0:
            got["blocks"] = _block_partials(torch)
        torch.save(got, f"{out}.{rank}")
    finally:
        dist.destroy_process_group()


def _block_partials(torch):
    """The Table-1 step's path gradient as MESH_WORKERS blocks in turn: each
    block's parameter partial (for the reorder bound)."""
    from repro_torch.benchmarks import table1_ou as t1
    from repro_torch.core import path_keys, prng, sdeint
    from repro_torch.core.pytree import tree_flatten, tree_unflatten
    from repro_torch.nsde import init_lsde, lsde_readout, lsde_term, moment_mse

    _, spec, n_steps = _ees_table1()
    params = init_lsde(0, t1.D_OBS, t1.D_Z, t1.WIDTH, device="cuda")
    leaves = list(params.parameters())
    tgt = torch.as_tensor(t1.target_paths(), dtype=torch.float32, device="cuda")
    keys = path_keys(prng.PRNGKey(1, device="cuda"), 256)
    b = 256 // MESH_WORKERS
    flats = []
    for r in range(MESH_WORKERS):
        res = sdeint(lsde_term(), spec, 0.0, t1.T, n_steps,
                     torch.zeros(t1.D_Z, device="cuda") + params.encoder.b, None,
                     args=params, adjoint="reversible", save_every=n_steps // 2,
                     batch_keys=keys[r * b:(r + 1) * b], device="cuda")
        flat, treedef = tree_flatten(res)
        flats.append(flat)
    whole = [torch.cat([f[i].detach() for f in flats]) for i in range(len(flats[0]))]
    floats = [i for i, x in enumerate(whole) if x.is_floating_point()]
    for i in floats:
        whole[i].requires_grad_()
    loss = moment_mse(lsde_readout(params, tree_unflatten(treedef, whole).ys)[..., 0], tgt)
    f_bar = torch.autograd.grad(loss, [whole[i] for i in floats], allow_unused=True)
    parts = []
    for r, flat in enumerate(flats):
        pull = [(flat[i], fb[r * b:(r + 1) * b]) for i, fb in zip(floats, f_bar)
                if fb is not None and flat[i].requires_grad]
        g = torch.autograd.grad([o for o, _ in pull], leaves, [c for _, c in pull],
                                allow_unused=True)
        parts.append([torch.zeros_like(p).cpu() if x is None else x.cpu()
                      for p, x in zip(leaves, g)])
    return parts


def mesh_phase(torch, params, y0, sync_abc):
    """Phase 20: (a) requests A-C through ``SDESampleEngine`` with its
    slots sharded on a sample mesh of one NCCL rank, bitwise phase 4's
    drain; (b) the Table-1 EES(2,5) step on a train mesh of one rank,
    bitwise the step without one, and captured by ``make_scanned_step``;
    (c) two processes on the one card over gloo: request A and one step.
    Returns ``{kernel: launches}`` of 20a-20b's paths."""
    import torch.distributed as dist

    from repro_torch.core import prng
    from repro_torch.kernels import WS_STAGE_DIAG, WS_STAGE_DIAG_BWD
    from repro_torch.launch.mesh import make_sample_mesh, make_train_mesh
    from repro_torch.nsde import lsde_term
    from repro_torch.serving import SDESampleConfig, SDESampleEngine
    from repro_torch.train import init_scan_counters, make_scanned_step

    # 20c's ranks start first: they take ~8 s to reach the card
    tmp_dir = tempfile.TemporaryDirectory()
    tmp = tmp_dir.name
    port_c = _free_port()
    code = ("import sys; sys.path[:0] = [{!r}, {!r}]; import chip_smoke; "
            "chip_smoke.mesh_worker({}, {}, {!r})")
    workers = [subprocess.Popen([sys.executable, "-c", code.format(
        REPO, SRC, r, port_c, os.path.join(tmp, "rank"))], cwd=REPO, text=True,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE) for r in range(MESH_WORKERS)]
    try:
        dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{_free_port()}", rank=0,
                                world_size=1)
        try:
            # (a) A-C on sharded slots
            mesh = make_sample_mesh(1)
            with torch.no_grad():
                engine = SDESampleEngine(lsde_term(), y0, SDESampleConfig(
                    slots=SERVE_SLOTS, ticks_per_dispatch=2, mesh=mesh, mesh_axis="mc"),
                    args=params, device="cuda")
                engine.submit("ees25:use_kernels=True", t1=2.0, n_steps=8, n_paths=1024,
                              seed=99)
                engine.run()  # warm-up outside the count
                WS_STAGE_DIAG.launches = 0
                torch.cuda.synchronize()
                start = time.perf_counter()
                rids = [engine.submit(s, t1=t1_, n_steps=n, n_paths=p, save_every=se, seed=seed)
                        for s, t1_, n, p, se, seed in ABC]
                done = engine.run()
                torch.cuda.synchronize()
                wall = time.perf_counter() - start
            launches = {"ws_stage_diag": WS_STAGE_DIAG.launches}
            same = all(_host_same(done[r], w) for r, w in zip(rids, sync_abc))
            stats = engine.executor.graph_stats()
            print(f"  (a) the NCCL mesh's executor is graphed: {engine.executor.graphed}; "
                  f"{stats['graphs']} tick graphs (the all-gather captured with the solve), "
                  f"{stats['replays']} replays for {engine.executor.n_ticks} ticks, "
                  f"shared pool {stats['pool_mib']:.1f} MiB", flush=True)
            check(engine.executor.graphed and stats["replays"] == engine.executor.n_ticks,
                  "20a: a tick of the NCCL mesh's drain ran outside its tick graph")
            n_paths = sum(p for _, _, _, p, _, _ in ABC)
            print(f"  (a) A-C with slots sharded on make_sample_mesh(1) (one NCCL rank, axis "
                  f"'mc'): bitwise equal to phase 4's drain: {same}; {n_paths} paths in "
                  f"{wall:.3f} s, {n_paths / wall:.0f} paths/s (phase 4: "
                  f"{MEASURED['phase4_paths_per_s']:.0f} paths/s over A-D, host wall with "
                  f"delivery); ws_stage_diag launches {launches['ws_stage_diag']}", flush=True)
            check(same, "20a: the sharded drain differs from phase 4's")
            check(launches["ws_stage_diag"] > 0, "20a launched no ws_stage_diag")

            # (b) the Table-1 step on a train mesh of one rank
            name, spec, n_steps = _ees_table1()
            kw = dict(n_steps=n_steps, save_every=n_steps // 2, adjoint="reversible")
            runs, step_ms = {}, {}
            for label, mkw in (("plain", {}), ("mesh", {"mesh": make_train_mesh(1),
                                                        "mesh_axis": "dp"})):
                step, _, p, state, key = _lsde_step(torch, spec, "cuda", **kw, **mkw)
                warm = _lsde_step(torch, spec, "cuda", **kw, **mkw)
                step(warm[2], warm[3], warm[4])  # a warm-up step on other weights
                WS_STAGE_DIAG_BWD.launches = 0
                losses = []
                torch.cuda.synchronize()
                start = time.perf_counter()
                for i in range(MESH_TRAIN_STEPS):
                    p, state, m = step(p, state, prng.fold_in(key, i))
                    losses.append(m["loss"])
                torch.cuda.synchronize()
                step_ms[label] = (time.perf_counter() - start) / MESH_TRAIN_STEPS * 1e3
                runs[label] = (p, state, torch.stack(losses))
                if label == "mesh":
                    launches["ws_stage_diag_bwd"] = WS_STAGE_DIAG_BWD.launches
            bitwise = (_pair_equal(torch, runs["plain"][:2], runs["mesh"][:2])
                       and torch.equal(runs["plain"][2], runs["mesh"][2]))
            print(f"  (b) {name} ({spec}, {n_steps} steps, reversible adjoint), "
                  f"{MESH_TRAIN_STEPS} AdamW steps on make_train_mesh(1) (axis 'dp') vs "
                  f"without a mesh: parameters, optimizer state and losses bitwise: "
                  f"{bitwise}; ms a step (host wall, after a warm-up step) mesh "
                  f"{step_ms['mesh']:.2f}, plain {step_ms['plain']:.2f} (phase 7: "
                  f"{MEASURED['phase7_ees_us'] / 1e3:.2f} over 60 epochs); "
                  f"ws_stage_diag_bwd launches {launches['ws_stage_diag_bwd']}", flush=True)
            check(bitwise, "20b: the mesh step differs from the single-device step")
            check(launches["ws_stage_diag_bwd"] > 0, "20b launched no ws_stage_diag_bwd")
            # the mesh step captured into a CUDA graph, against sequential steps
            step, _, p_g, state_g, key_g = _lsde_step(torch, spec, "cuda", **kw,
                                                      mesh=make_train_mesh(1), mesh_axis="dp")
            scanned = make_scanned_step(step, MESH_TRAIN_STEPS)
            p_g, state_g, counters, hist = scanned(p_g, state_g, init_scan_counters("cuda"),
                                                   key_g, 0)
            torch.cuda.synchronize()
            replay = (scanned.graphed and _pair_equal(torch, (p_g, state_g), runs["mesh"][:2])
                      and torch.equal(hist["loss"], runs["mesh"][2]))
            print(f"  (b) make_scanned_step captured the mesh step into a CUDA graph: "
                  f"{scanned.graphed} (capturable={step.capturable}); its chunk of "
                  f"{MESH_TRAIN_STEPS} bitwise the sequential mesh steps: {replay}", flush=True)
            check(replay, "20b: the graphed mesh step differs from the sequential steps")
            del scanned, step
            torch.cuda.synchronize()
        finally:
            dist.destroy_process_group()

        # (c) two ranks on the one card over gloo
        for r, proc in enumerate(workers):
            _, err = proc.communicate(timeout=600)
            check(proc.returncode == 0, f"20c rank {r} failed (rc {proc.returncode}): "
                  f"{err[-3000:]}")
        ranks = [torch.load(os.path.join(tmp, f"rank.{r}"), weights_only=False)
                 for r in range(MESH_WORKERS)]
        a_same = all(np.array_equal(ranks[r]["a"][f], getattr(sync_abc[0], f))
                     for r in range(MESH_WORKERS) for f in ("y_final", "diverged"))
        check(not any(r["graphed"] for r in ranks),
              "20c: an executor on a gloo mesh captured tick graphs")
        a_err = float(np.abs(ranks[0]["a"]["y_final"] - sync_abc[0].y_final).max())
        ranks_same = (torch.equal(ranks[0]["loss"], ranks[1]["loss"])
                      and all(torch.equal(x, y) for x, y in zip(ranks[0]["grads"],
                                                                ranks[1]["grads"])))
        loss, grads = _mesh_grad(torch)
        eps = torch.finfo(torch.float32).eps
        ratio = 0.0
        for i, (g2, g1) in enumerate(zip(ranks[0]["grads"], grads)):
            spread = sum(part[i].abs() for part in ranks[0]["blocks"])
            d = (g2 - g1.cpu()).abs()
            ratio = max(ratio, (d / (eps * spread).clamp_min(1e-38)).max().item())
        loss_rel = abs(ranks[0]["loss"].item() / loss.item() - 1.0)
        loss_bitwise = torch.equal(ranks[0]["loss"], loss.cpu())
        print(f"  (c) {MESH_WORKERS} processes on the one card (gloo, CUDA tensors): request A "
              f"({ABC[0][3]} paths) sharded bitwise to 20a's and phase 4's: {a_same} "
              f"(max|diff| {a_err:.3e}); one Table-1 step: both ranks' gradients equal: "
              f"{ranks_same}; loss vs one device {loss_rel:.3e} relative (bitwise: "
              f"{loss_bitwise}); gradient vs one "
              f"device at most {ratio:.3f} eps sum_r |g_r| (limit {256 // MESH_WORKERS - 1}: "
              f"the reorder bound of a block's {256 // MESH_WORKERS} paths over the blocks' "
              f"partials); the gloo ranks' executors ran eagerly", flush=True)
        check(a_err <= 1e-5 * max(1.0, float(np.abs(sync_abc[0].y_final).max())),
              "20c: request A sharded over two ranks differs from one rank's")
        check(ranks_same and loss_rel <= 1e-6 and ratio <= 256 // MESH_WORKERS - 1,
              "20c: the two-rank step's gradient is outside the reorder bound")
    finally:  # a failed gate above leaves no rank running
        for proc in workers:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        tmp_dir.cleanup()
    return launches


TP_TRAIN_STEPS = 2           # 21a: AdamW steps on a (1, 1) mesh against no mesh
TP_GRAPH_K = 2               # 21a: DTensor steps a graphed chunk of train_loop
TP_WORKERS = 2               # 21b: ranks on the one card (gloo), a (1, 2) mesh
TP_F32 = (2, 1, 512)         # 21b: zamba2-7b float32 (layers, batch, tokens)
TP_BF16 = (4, 1, 2048)       # 21b: zamba2-7b bf16, one training step
TP_MOE = (2, 2, 2048)        # 21b: olmoe-1b-7b prefill, float32 and bf16
TP_DECODE = (2, 4)           # 21b: zamba2-7b float32 decode: batch, ticks
TP_LOGIT_REL = 1e-5          # 21b float32 logits (zamba2-7b; olmoe before a flip), of max|logit|
TP_LOSS_ATOL = 2e-2          # 21b bf16 loss (the reference's, tests/test_launch_distributed.py)
TP_MOE_REL = 2e-2            # 21b bf16 moe logits before a flip, of max|logit|
# 21b bf16 moe: tokens whose expert set flips against the one-rank run.
# The row-parallel sums' bf16 rounding moves the router's near-ties: a
# one-rank witness with that rounding flips the same 14.45% and equals the
# two ranks bitwise (NVIDIA H100 80GB HBM3, 700 W), which is gated.
TP_MOE_FLIP = 0.2


class _RecordedGrads:
    """An optimizer that keeps the gradients of its last update (each
    rank's local tensors) and otherwise is ``inner``."""

    def __init__(self, inner):
        self.inner, self.grads = inner, None

    def init(self, params):
        return self.inner.init(params)

    def update(self, grads, state, params):
        self.grads = [getattr(g, "to_local", lambda g=g: g)() for g in grads]
        return self.inner.update(grads, state, params)


def _local(t):
    return t.to_local() if hasattr(t, "to_local") else t


def tp_one_rank_card(torch):
    """21a: zamba2-7b at full width, bf16, 12 layers, B = 2 x 2048, remat:
    two AdamW steps of ``make_train_step`` with every parameter a DTensor
    on a ("data", "model") mesh of one NCCL rank under
    ``ShardingPolicy(("data",), "model")``, step by step beside the same
    steps without a mesh: losses, gradients and parameters bitwise; the
    mesh run's launches of the four LM kernels by route; ms a step of
    both.  Returns the mesh run's launches."""
    from contextlib import nullcontext

    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.configs import get_arch
    from repro_torch.core import prng
    from repro_torch.data import DataConfig, SyntheticTokens
    from repro_torch.kernels.flash_attention.flash_attention import (BWD_ROUTE_LAUNCHES,
                                                                     ROUTE_LAUNCHES)
    from repro_torch.launch.mesh import param_shardings, place
    from repro_torch.models import ModelOptions, ShardingPolicy, init_params, make_train_step
    from repro_torch.optim import adamw, cosine_schedule

    cfg = dataclasses.replace(get_arch("zamba2-7b"), n_layers=LM_TRAIN_LAYERS)
    n_inv = -(-cfg.n_layers // cfg.shared_attn_every)
    data = SyntheticTokens(DataConfig(LM_TRAIN_BATCH, LM_TRAIN_LEN, cfg.vocab))
    batches = [{k: torch.as_tensor(v, device="cuda") for k, v in data.batch_at(i).items()}
               for i in range(TP_TRAIN_STEPS)]
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{_free_port()}", rank=0,
                            world_size=1)
    try:
        mesh = DeviceMesh("cuda", torch.zeros(1, 1, dtype=torch.int64),
                          mesh_dim_names=("data", "model"))
        runs = {}
        for label in ("plain", "mesh"):
            params = init_params(cfg, prng.PRNGKey(0, device="cuda"), device="cuda")
            opts = ModelOptions(remat=True)
            if label == "mesh":
                place(params, param_shardings(mesh, params))
                opts = ModelOptions(remat=True, shard=ShardingPolicy(("data",), "model"))
            opt = _RecordedGrads(adamw(cosine_schedule(3e-4, 10, LM_TRAIN_STEPS)))
            runs[label] = {"params": params, "opt": opt,
                           "state": opt.init(list(params.parameters())),
                           "step": make_train_step(cfg, opt, opts), "walls": [],
                           "losses": [], "ctx": mesh if label == "mesh" else nullcontext()}
        launched, fwd, bwd = {}, dict.fromkeys(ROUTE_LAUNCHES, 0), dict.fromkeys(
            BWD_ROUTE_LAUNCHES, 0)
        same_grads = True
        for i in range(TP_TRAIN_STEPS):
            for label, r in runs.items():
                _zero_launches()
                ROUTE_LAUNCHES.update(dict.fromkeys(ROUTE_LAUNCHES, 0))
                BWD_ROUTE_LAUNCHES.update(dict.fromkeys(BWD_ROUTE_LAUNCHES, 0))
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                with r["ctx"]:
                    _, r["state"], metrics = r["step"](r["params"], r["state"], batches[i])
                torch.cuda.synchronize()
                r["walls"].append(time.perf_counter() - t0)
                r["losses"].append(metrics["loss"])
                if label == "mesh":
                    for k, n in _read_launches().items():
                        launched[k] = launched.get(k, 0) + n
                    for k in fwd:
                        fwd[k] += ROUTE_LAUNCHES[k]
                    for k in bwd:
                        bwd[k] += BWD_ROUTE_LAUNCHES[k]
            same_grads &= all(torch.equal(a, b) for a, b in zip(runs["plain"]["opt"].grads,
                                                                runs["mesh"]["opt"].grads))
            for r in runs.values():
                r["opt"].grads = None
        same_params = all(torch.equal(a, _local(b)) for a, b in zip(
            runs["plain"]["params"].parameters(), runs["mesh"]["params"].parameters()))
        same_losses = torch.equal(torch.stack(runs["plain"]["losses"]),
                                  torch.stack(runs["mesh"]["losses"]))
        placed = sum(1 for p in runs["mesh"]["params"].parameters() if hasattr(p, "to_local"))
        n_par = len(list(runs["mesh"]["params"].parameters()))
        del runs["plain"]["params"], runs["plain"]["state"], runs["mesh"]["state"]
        torch.cuda.empty_cache()
        graphed = _tp_graphed(torch, cfg, mesh, data, runs["mesh"])
    finally:
        dist.destroy_process_group()
    walls = {label: ", ".join(f"{w * 1e3:.1f}" for w in r["walls"]) for label, r in runs.items()}
    print(f"  (a) zamba2-7b bf16, {cfg.n_layers} of 81 layers at full width, B="
          f"{LM_TRAIN_BATCH} x {LM_TRAIN_LEN}, remat: {TP_TRAIN_STEPS} AdamW steps of "
          f"make_train_step with {placed} of {n_par} parameters DTensors on a (1, 1) "
          f"('data', 'model') mesh of one NCCL rank: losses "
          f"{', '.join(f'{float(v):.6f}' for v in runs['mesh']['losses'])}; bitwise the "
          f"steps without a mesh: losses {same_losses}, every gradient {same_grads}, every "
          f"parameter {same_params}; ms a step (host wall, step 1 with its warm-up) mesh "
          f"{walls['mesh']}, no mesh {walls['plain']}; the mesh run's launches {launched}; "
          f"flash_attention by route {fwd}, flash_attention_bwd by route {bwd}", flush=True)
    check(placed == n_par, "21a: not every parameter is a DTensor")
    check(same_losses and same_grads and same_params,
          "21a: the (1, 1) mesh steps differ from the steps without a mesh")
    want = {"flash_attention": 2 * n_inv * TP_TRAIN_STEPS,
            "ssd_scan": 2 * cfg.n_layers * TP_TRAIN_STEPS,
            "flash_attention_bwd": n_inv * TP_TRAIN_STEPS,
            "ssd_scan_bwd": cfg.n_layers * TP_TRAIN_STEPS}
    check({k: launched.get(k, 0) for k in want} == want,
          f"21a: the LM kernels launched {launched}, not {want}")
    mesh_ms = runs["mesh"]["walls"][-1] * 1e3
    print(f"  (a) graphed: the mesh steps again, through train_loop with K={TP_GRAPH_K} "
          f"(one CUDA graph): bitwise the eager mesh steps: parameters "
          f"{graphed['same_params']}, losses {graphed['same_losses']}; capture "
          f"{graphed['capture']:.2f} s; ms a step, host wall / device ({graphed['ms'][2]}): a "
          f"replay {graphed['ms'][0]:.2f} / {graphed['ms'][1]:.2f}, against the eager mesh "
          f"step's host wall {mesh_ms:.1f} (step {TP_TRAIN_STEPS} above): the graph removes "
          f"{1 - graphed['ms'][0] / mesh_ms:.1%} of it; card {card_line()}", flush=True)
    check(graphed["same_params"] and graphed["same_losses"],
          "21a: the graphed DTensor chunks differ from the eager ones")
    check(fwd["wgmma"] == want["flash_attention"]
          and bwd["wgmma"] == want["flash_attention_bwd"],
          f"21a: the attention took the routes {fwd} / {bwd}")
    del runs, batches
    torch.cuda.empty_cache()
    return {k: launched.get(k, 0) for k in LM_KERNELS}


def _tp_graphed(torch, cfg, mesh, data, eager):
    """21a's graphed part, on the live (1, 1) NCCL mesh: ``make_train_step``
    on DTensor parameters under ``ShardingPolicy(("data", ), "model")``,
    from the same weights, optimizer and batches as 21a's eager mesh steps
    (``eager``), through ``train_loop`` with K = TP_GRAPH_K: the chunk runs
    as one CUDA graph (the step is marked capturable), and its parameters
    and losses must be bitwise the eager steps'.  Returns that, the capture
    seconds and a replay's ms a step (host wall, device).  A capture that
    fails raises."""
    from repro_torch.core import prng
    from repro_torch.launch.mesh import param_shardings, place
    from repro_torch.models import ModelOptions, ShardingPolicy, init_params, make_train_step
    from repro_torch.optim import adamw, cosine_schedule
    from repro_torch.train import TrainLoopConfig, train_loop

    timer = Timer(torch)
    params = init_params(cfg, prng.PRNGKey(0, device="cuda"), device="cuda")
    place(params, param_shardings(mesh, params))
    opt = adamw(cosine_schedule(3e-4, 10, LM_TRAIN_STEPS))
    step = make_train_step(cfg, opt, ModelOptions(remat=True,
                                                  shard=ShardingPolicy(("data",), "model")))
    with mesh:
        res = train_loop(cfg, params, data, optimizer=opt, step_fn=step,
                         loop=TrainLoopConfig(steps=TP_TRAIN_STEPS, log_every=1,
                                              steps_per_call=TP_GRAPH_K))
    graph = res["graphs"].get(TP_GRAPH_K)
    check(graph is not None, "21a: train_loop ran the DTensor step's chunks eagerly")
    same_params = all(torch.equal(_local(a), _local(b)) for a, b in zip(
        eager["params"].parameters(), res["params"].parameters()))
    same_losses = [v for _, v in res["losses"]] == [float(v) for v in eager["losses"]]
    chunk = _stacked_batches(torch, data, range(TP_GRAPH_K))
    state = (res["params"], res["opt_state"])

    def replay():
        with mesh:
            graph(state, chunk)

    out = dict(same_params=same_params, same_losses=same_losses,
               capture=graph.capture_seconds, ms=_graph_ms(torch, timer, replay, TP_GRAPH_K))
    del res, state, graph, params, timer
    torch.cuda.empty_cache()
    return out


class _LocalShapes:
    """Records what the LM kernels' wrappers and the experts' GEMMs were
    handed on this rank (their module globals, wrapped): attention's
    (batch, query heads, KV heads, dtype), the scan's (batch, heads,
    state), the experts' local count, and the width of the logits the
    vocab-parallel loss takes."""

    def __enter__(self):
        from repro_torch.kernels.flash_attention import ops as fa_ops
        from repro_torch.kernels.ssd_scan import ops as ssd_ops
        from repro_torch.models import moe, transformer

        self.mods = (fa_ops, ssd_ops, moe, transformer)
        self.inner = (fa_ops.flash_attention, fa_ops.flash_attention_bwd, ssd_ops.ssd_scan,
                      ssd_ops.ssd_scan_bwd, moe._experts, transformer._sharded_nll_sums)
        self.seen = {k: set() for k in ("flash_attention", "flash_attention_bwd", "ssd_scan",
                                        "ssd_scan_bwd", "experts", "loss_vocab")}
        fa, fab, ssd, ssdb, experts, nll = self.inner

        def heads(name, fn):
            def wrapped(q, k, *a, **kw):
                self.seen[name].add((q.shape[0], q.shape[1], k.shape[1], str(q.dtype)[6:]))
                return fn(q, k, *a, **kw)
            return wrapped

        def scan(name, fn):
            def wrapped(x, dt, A, B, *a, **kw):
                self.seen[name].add((x.shape[0], x.shape[2], B.shape[2]))
                return fn(x, dt, A, B, *a, **kw)
            return wrapped

        def local_experts(p, xe):
            self.seen["experts"].add(p["wg"].shape[0])
            return experts(p, xe)

        def loss_vocab(logits, *a):
            self.seen["loss_vocab"].add(logits.shape[-1])
            return nll(logits, *a)

        fa_ops.flash_attention = heads("flash_attention", fa)
        fa_ops.flash_attention_bwd = heads("flash_attention_bwd", fab)
        ssd_ops.ssd_scan, ssd_ops.ssd_scan_bwd = scan("ssd_scan", ssd), scan("ssd_scan_bwd", ssdb)
        moe._experts = local_experts
        transformer._sharded_nll_sums = loss_vocab
        return self

    def __exit__(self, *exc):
        fa_ops, ssd_ops, moe, transformer = self.mods
        (fa_ops.flash_attention, fa_ops.flash_attention_bwd, ssd_ops.ssd_scan,
         ssd_ops.ssd_scan_bwd, moe._experts, transformer._sharded_nll_sums) = self.inner
        return False

    def report(self):
        return {k: sorted(v) for k, v in self.seen.items() if v}


def _tp_tokens(torch, cfg, b, s, seed):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, size=(b, s + 1))
    return {"tokens": torch.from_numpy(toks[:, :-1]).cuda(),
            "labels": torch.from_numpy(toks[:, 1:]).cuda()}


def _tp_grads(torch, cfg, params, batch, opts, ctx):
    """The loss's gradients, each laid out as its parameter and whole."""
    from repro_torch.models import loss_fn
    from repro_torch.models.transformer import settle
    from repro_torch.spmd import full

    leaves = list(params.parameters())
    with ctx:
        loss = loss_fn(cfg, params, batch, opts)
    grads = torch.autograd.grad(loss, leaves)
    return [full(settle(g, p)) for g, p in zip(grads, leaves)]


def _tp_checks(torch, rank):
    """21b on one rank of a (1, 2) ("data", "model") mesh: the float32
    forward and gradients, one bf16 training step, the moe prefill and a
    decode, each beside the one-rank run (rank 0 runs it first, without a
    mesh, while rank 1 waits)."""
    from contextlib import nullcontext

    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.configs import get_arch
    from repro_torch.core import prng
    from repro_torch.kernels.flash_attention.flash_attention import (BWD_ROUTE_LAUNCHES,
                                                                     ROUTE_LAUNCHES)
    from repro_torch.launch.mesh import cache_shardings, param_shardings, place
    from repro_torch.models import (ModelOptions, ShardingPolicy, forward, init_cache,
                                    init_params, make_train_step, moe, serve_step)
    from repro_torch.optim import adamw
    from repro_torch.spmd import full

    mesh = DeviceMesh("cuda", torch.arange(TP_WORKERS).reshape(1, TP_WORKERS),
                      mesh_dim_names=("data", "model"))
    policy = ShardingPolicy(("data",), "model")
    one = nullcontext()
    out = {}

    def fresh(cfg, seed=0, placed=True):
        params = init_params(cfg, prng.PRNGKey(seed, device="cuda"), device="cuda")
        return place(params, param_shardings(mesh, params)) if placed else params

    def counted(fn):
        _zero_launches()
        ROUTE_LAUNCHES.update(dict.fromkeys(ROUTE_LAUNCHES, 0))
        BWD_ROUTE_LAUNCHES.update(dict.fromkeys(BWD_ROUTE_LAUNCHES, 0))
        with _LocalShapes() as shapes:
            res = fn()
        torch.cuda.synchronize()
        return res, {"launches": _read_launches(), "fwd": dict(ROUTE_LAUNCHES),
                     "bwd": dict(BWD_ROUTE_LAUNCHES), "shapes": shapes.report()}

    # float32: logits and gradients
    layers, b, s = TP_F32
    cfg = dataclasses.replace(get_arch("zamba2-7b"), n_layers=layers, dtype="float32")
    batch = _tp_tokens(torch, cfg, b, s, 211)
    if rank == 0:
        ref = fresh(cfg, placed=False)
        with torch.no_grad():
            ref_logits = forward(cfg, ref, batch)[0]
        ref_grads = _tp_grads(torch, cfg, ref, batch, ModelOptions(), one)
    dist.barrier()
    params = fresh(cfg)
    opts = ModelOptions(shard=policy)

    def f32():
        with torch.no_grad(), mesh:
            logits = full(forward(cfg, params, batch, opts)[0])
        return logits, _tp_grads(torch, cfg, params, batch, opts, mesh)

    (logits, grads), out["f32"] = counted(f32)
    if rank == 0:
        got, want = logits[..., :cfg.vocab], ref_logits[..., :cfg.vocab]
        out["f32"]["logit_rel"] = ((got - want).abs().max() / want.abs().max()).item()
        big = max(g.abs().max().item() for g in ref_grads)
        out["f32"]["grad_ratio"] = max(
            (g - w).abs().max().item() / (LM_GRAD_REL * max(w.abs().max().item(), 1e-2 * big))
            for g, w in zip(grads, ref_grads))
        del ref_logits, ref_grads
    del logits, grads

    # decode: the same float32 weights, caches pinned by cache_pspecs
    nb, ticks = TP_DECODE
    prompts = torch.from_numpy(np.random.default_rng(212).integers(
        0, cfg.vocab, size=(nb,))).cuda()

    def decode(p, cache, dopts, ctx):
        tok, toks = prompts, []
        with torch.no_grad(), ctx:
            for pos in range(ticks):
                logits, cache = serve_step(cfg, p, cache, tok, pos, dopts)
                tok = full(logits).argmax(-1)
                toks.append(tok)
        return torch.stack(toks)

    cache = init_cache(cfg, nb, ticks, device="cuda")
    shardings, pins = cache_shardings(mesh, cache, batch=nb)
    toks, out["decode"] = counted(lambda: decode(
        params, place(cache, shardings), ModelOptions(shard=policy, cache_constraints=pins),
        mesh))
    if rank == 0:
        want = decode(ref, init_cache(cfg, nb, ticks, device="cuda"), ModelOptions(), one)
        out["decode"]["tokens_equal"] = bool(torch.equal(toks, want))
        out["decode"]["tokens"] = toks.tolist()
        del ref
    del params, cache
    torch.cuda.empty_cache()

    # bf16: one training step
    layers, b, s = TP_BF16
    cfg = dataclasses.replace(get_arch("zamba2-7b"), n_layers=layers)
    batch = _tp_tokens(torch, cfg, b, s, 213)
    opt = adamw(3e-4)
    if rank == 0:
        ref = fresh(cfg, placed=False)
        t0 = time.perf_counter()
        _, _, m = make_train_step(cfg, opt, ModelOptions(remat=True))(
            ref, opt.init(list(ref.parameters())), batch)
        ref_loss = float(m["loss"])
        out["one_rank_step_ms"] = (time.perf_counter() - t0) * 1e3
        del ref, m
        torch.cuda.empty_cache()
    dist.barrier()
    params = fresh(cfg)
    state = opt.init(list(params.parameters()))
    step = make_train_step(cfg, opt, ModelOptions(remat=True, shard=policy))

    def bf16():
        t0 = time.perf_counter()
        with mesh:
            _, _, m = step(params, state, batch)
        torch.cuda.synchronize()
        return float(m["loss"]), (time.perf_counter() - t0) * 1e3

    (loss, ms), out["bf16"] = counted(bf16)
    out["bf16"].update(loss=loss, step_ms=ms)
    if rank == 0:
        out["bf16"]["ref_loss"] = ref_loss
    del params, state, step
    torch.cuda.empty_cache()

    # moe: olmoe-1b-7b prefill, experts split over the model axis; float32
    # (routing held as phase 19 holds it), then bf16, also beside a one-rank
    # witness whose attention output products (olmoe's only row-parallel
    # ones: its experts are split whole) are split as the mesh splits them
    layers, b, s = TP_MOE
    for dtype in ("float32", "bfloat16"):
        cfg = dataclasses.replace(get_arch("olmoe-1b-7b"), n_layers=layers, dtype=dtype)
        batch = _tp_tokens(torch, cfg, b, s, 214)
        if rank == 0:
            ref = fresh(cfg, placed=False)
            with torch.no_grad(), _ExpertSets(moe) as rec:
                ref_logits = forward(cfg, ref, batch)[0]
            ref_sets = rec.calls
            if dtype == "bfloat16":
                wo = [w for n, w in ref.named_parameters() if n.split(".")[-1] == "wo"]
                with (torch.no_grad(), _ExpertSets(moe) as rec,
                      _split_row_products(torch, wo, TP_WORKERS)):
                    wit_logits = forward(cfg, ref, batch)[0]
                wit_sets, n_split = rec.calls, len(wo)
            del ref
            torch.cuda.empty_cache()
        dist.barrier()
        params = fresh(cfg)

        def prefill():
            with torch.no_grad(), mesh, _ExpertSets(moe) as rec:
                logits = full(forward(cfg, params, batch, ModelOptions(shard=policy))[0])
            return logits, rec.calls

        (logits, sets), out[f"moe {dtype}"] = counted(prefill)
        if rank == 0:
            rep = out[f"moe {dtype}"]
            n_flip, n_keep, err = _flip_err(torch, logits, ref_logits, sets, ref_sets,
                                            cfg.vocab)
            rep.update(flip_share=n_flip / (b * s), kept=n_keep, logit_rel=err,
                       max_logit=ref_logits[..., :cfg.vocab].abs().max().item(),
                       finite=bool(torch.isfinite(logits).all()),
                       shape_ok=tuple(logits.shape) == (b, s, cfg.padded_vocab))
            if dtype == "bfloat16":
                n_flip, n_keep, err = _flip_err(torch, wit_logits, ref_logits, wit_sets,
                                                ref_sets, cfg.vocab)
                rep["witness"] = dict(flip_share=n_flip / (b * s), kept=n_keep, logit_rel=err,
                                      split=n_split)
                n_flip, n_keep, err = _flip_err(torch, logits, wit_logits, sets, wit_sets,
                                                cfg.vocab)
                rep["vs_witness"] = dict(flip_share=n_flip / (b * s), kept=n_keep,
                                         logit_rel=err,
                                         bitwise=bool(torch.equal(logits, wit_logits)))
                del wit_logits, wit_sets
            del ref_logits, ref_sets
        del params, logits, sets
        torch.cuda.empty_cache()
    return out


def tp_worker(rank: int, port: int, out: str) -> None:
    """A phase-21b rank (its own process): a gloo world of TP_WORKERS on the
    one card; its report saved to ``out.<rank>`` as JSON.  A crash prints
    its Python stack (``faulthandler``) to the stderr phase 21 reports."""
    import faulthandler

    import torch
    import torch.distributed as dist

    faulthandler.enable()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    torch.cuda.set_device(0)  # both ranks share the one card
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=TP_WORKERS)
    try:
        report = _tp_checks(torch, rank)
        with open(f"{out}.{rank}", "w") as f:
            json.dump(report, f, default=list)
    finally:
        dist.destroy_process_group()


def tp_phase(torch):
    """Phase 21: the LM's tensor, expert and sequence parallelism on DTensor.
    (a) a (1, 1) mesh of one NCCL rank against no mesh, bitwise; (b) two
    processes on the one card over gloo on a (1, 2) mesh.  Returns 21a's
    launches."""
    launches = tp_one_rank_card(torch)
    start = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        port = _free_port()
        code = ("import sys; sys.path[:0] = [{!r}, {!r}]; import chip_smoke; "
                "chip_smoke.tp_worker({}, {}, {!r})")
        workers = [subprocess.Popen([sys.executable, "-c", code.format(
            REPO, SRC, r, port, os.path.join(tmp, "rank"))], cwd=REPO, text=True,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE) for r in range(TP_WORKERS)]
        try:
            for r, proc in enumerate(workers):
                _, err = proc.communicate(timeout=600)
                check(proc.returncode == 0, f"21b rank {r} failed (rc {proc.returncode}): "
                      f"{err[-4000:]}")
        finally:  # a failed gate above leaves no rank running
            for proc in workers:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        ranks = []
        for r in range(TP_WORKERS):
            with open(os.path.join(tmp, f"rank.{r}")) as f:
                ranks.append(json.load(f))
    zero = ranks[0]
    for r, rep in enumerate(ranks):
        for part in ("f32", "decode", "bf16", "moe float32", "moe bfloat16"):
            print(f"  (b) rank {r}, {part}: launches {rep[part]['launches']}; flash_attention "
                  f"by route {rep[part]['fwd']}, flash_attention_bwd by route "
                  f"{rep[part]['bwd']}; local shapes {rep[part]['shapes']}", flush=True)
    f32, bf16, dec = zero["f32"], zero["bf16"], zero["decode"]
    moe32, moe16 = zero["moe float32"], zero["moe bfloat16"]
    from repro_torch.configs import get_arch

    vocab = get_arch("zamba2-7b").padded_vocab
    for r, rep in enumerate(ranks):
        widths = {part: rep[part]["shapes"].get("loss_vocab") for part in ("f32", "bf16")}
        print(f"  (b) rank {r}: the loss's local logits width (the vocab-parallel "
              f"log-softmax), float32 gradients {widths['f32']}, bf16 step {widths['bf16']}, of "
              f"{vocab} columns", flush=True)
        check(all(w == [vocab // TP_WORKERS] for w in widths.values()),
              f"21b rank {r}: the loss took logits of widths {widths}, not {vocab // TP_WORKERS}")
    print(f"  (b) {TP_WORKERS} processes on the one card (gloo, CUDA tensors), mesh (1, "
          f"{TP_WORKERS}): zamba2-7b float32 {TP_F32[0]} layers B={TP_F32[1]} x {TP_F32[2]}: "
          f"logits {f32['logit_rel']:.3e} of max|logit| from the one-rank run (limit "
          f"{TP_LOGIT_REL:g}), gradients at most {f32['grad_ratio']:.3f} of 18b's limit "
          f"({LM_GRAD_REL:g} of each leaf's max|.|, at least 1% of the largest leaf's); "
          f"bf16 {TP_BF16[0]} layers B={TP_BF16[1]} x {TP_BF16[2]}, one AdamW step: loss "
          f"{bf16['loss']:.6f} vs one rank {bf16['ref_loss']:.6f} (limit {TP_LOSS_ATOL:g}); "
          f"{bf16['step_ms']:.1f} ms (rank 0), {ranks[1]['bf16']['step_ms']:.1f} ms (rank 1), "
          f"one rank without a mesh {zero['one_rank_step_ms']:.1f} ms (host wall, first step "
          f"each); olmoe-1b-7b {TP_MOE[0]} layers prefill B={TP_MOE[1]} x {TP_MOE[2]}, float32: "
          f"{moe32['flip_share']:.2%} of tokens route to another expert set in some layer "
          f"(limit {P19_FLIP_SHARE:.0%}), on the {moe32['kept']} tokens before each "
          f"sequence's first such token max |diff| {moe32['logit_rel']:.3e} of max|logit| "
          f"({moe32['max_logit']:.4f}; limit {TP_LOGIT_REL:g}); bf16: "
          f"{moe16['flip_share']:.2%} flipped (limit {TP_MOE_FLIP:.0%}), on the "
          f"{moe16['kept']} tokens before the first flips max |diff| "
          f"{moe16['logit_rel']:.3e} of max|logit| ({moe16['max_logit']:.4f}; limit "
          f"{TP_MOE_REL:g}); the one-rank witness with its {moe16['witness']['split']} "
          f"attention output products split in {TP_WORKERS} and summed in bf16: "
          f"{moe16['witness']['flip_share']:.2%} flipped against the one-rank run, max |diff| "
          f"{moe16['witness']['logit_rel']:.3e} on {moe16['witness']['kept']} tokens; the "
          f"two ranks against the witness: {moe16['vs_witness']['flip_share']:.2%} flipped, "
          f"max |diff| {moe16['vs_witness']['logit_rel']:.3e} of max|logit| on "
          f"{moe16['vs_witness']['kept']} tokens, bitwise (gated) "
          f"{moe16['vs_witness']['bitwise']}; zamba2-7b "
          f"decode, {TP_DECODE[1]} ticks of B={TP_DECODE[0]} with cache_pspecs-pinned "
          f"caches: greedy tokens equal to the one-rank run's: {dec['tokens_equal']} "
          f"{dec['tokens']}; "
          f"{time.perf_counter() - start:.1f} s", flush=True)
    check(f32["logit_rel"] <= TP_LOGIT_REL, "21b: the float32 logits are outside the limit")
    check(f32["grad_ratio"] <= 1.0, "21b: the float32 gradients are outside the limit")
    check(abs(bf16["loss"] - bf16["ref_loss"]) <= TP_LOSS_ATOL
          and bf16["loss"] == ranks[1]["bf16"]["loss"], "21b: the bf16 step's loss is off")
    check(moe32["flip_share"] <= P19_FLIP_SHARE and moe32["kept"] > 0
          and moe32["logit_rel"] <= TP_LOGIT_REL,
          "21b: the float32 moe prefill is outside its limits")
    check(moe16["finite"] and moe16["shape_ok"] and moe16["kept"] > 0
          and moe16["flip_share"] <= TP_MOE_FLIP and moe16["logit_rel"] <= TP_MOE_REL,
          "21b: the bf16 moe prefill is not finite, of the wrong shape or outside its limits")
    check(moe16["vs_witness"]["bitwise"],
          "21b: the bf16 moe prefill differs from the one-rank witness of its reduction")
    check(dec["tokens_equal"], "21b: the sharded decode's tokens differ")
    f32_cfg, moe_cfg = get_arch("zamba2-7b"), get_arch("olmoe-1b-7b")
    half = TP_WORKERS
    for r, rep in enumerate(ranks):
        for part, want in (("f32", {"flash_attention": (TP_F32[1], f32_cfg.n_heads // half,
                                                        f32_cfg.n_kv_heads // half, "float32"),
                                    "ssd_scan": (TP_F32[1], f32_cfg.ssm_heads // half,
                                                 f32_cfg.ssm_state)}),
                           ("bf16", {"flash_attention": (TP_BF16[1], f32_cfg.n_heads // half,
                                                         f32_cfg.n_kv_heads // half, "bfloat16"),
                                     "ssd_scan": (TP_BF16[1], f32_cfg.ssm_heads // half,
                                                  f32_cfg.ssm_state)}),
                           *((f"moe {dt}", {"flash_attention": (
                               TP_MOE[1], moe_cfg.n_heads // half, moe_cfg.n_kv_heads // half, dt),
                               "experts": moe_cfg.n_experts // half})
                             for dt in ("float32", "bfloat16"))):
            rep_p = rep[part]
            for name, shape in want.items():
                check([list(shape)] == rep_p["shapes"].get(name) if name != "experts"
                      else rep_p["shapes"].get(name) == [shape],
                      f"21b rank {r} {part}: {name} saw {rep_p['shapes'].get(name)}, "
                      f"not {shape}")
            check(all(rep_p["launches"].get(k, 0) > 0 for k in (
                ("flash_attention", "ssd_scan", "flash_attention_bwd", "ssd_scan_bwd")
                if not part.startswith("moe") else ("flash_attention",))),
                f"21b rank {r} {part}: the LM kernels launched {rep_p['launches']}")
            # float32 attention: forward on mma_tf32, backward on its one
            # (SIMT) route; bf16: both on wgmma
            f32_part = want["flash_attention"][3] == "float32"
            launched = rep_p["launches"]
            check(rep_p["fwd"]["mma_tf32" if f32_part else "wgmma"]
                  == launched.get("flash_attention", 0)
                  and rep_p["bwd"]["simt" if f32_part else "wgmma"]
                  == launched.get("flash_attention_bwd", 0),
                  f"21b rank {r} {part}: attention took the routes {rep_p['fwd']} / "
                  f"{rep_p['bwd']}")
    return launches


DRYRUN_FLOP_REL = 1e-6       # 22b: predicted FLOPs against FlopCounterMode's (the same ops)
DRYRUN_PEAK_REL = 0.10       # 22b: the predicted peak against the plain path's measured one
DRYRUN_CELLS = (("qwen3-1.7b", "train_4k", "single"), ("zamba2-7b", "decode_32k", "multi"),
                ("yi-9b", "decode_32k", "single"))
# 22c: predicted peaks a rank (GiB) before the vocab-parallel loss, decode q
# on the cache's batch shard and query heads over a gathered KV group (the
# dry run's table, PERF.md)
DRYRUN_PEAKS_BEFORE = {("qwen3-1.7b", "train_4k", "single"): 122.02,
                       ("yi-9b", "decode_32k", "single"): 169.57}
DRYRUN_TIMEOUT = 300         # s, each dry-run process

_DRYRUN_ONE_RANK = r"""
import dataclasses, json, sys
sys.path[:0] = [{src!r}]
import torch
from torch.distributed.device_mesh import DeviceMesh
from repro_torch.configs import ShapeSpec, get_arch
from repro_torch.launch import dryrun
cfg = dataclasses.replace(get_arch("zamba2-7b"), n_layers={layers})
dryrun.fake_world(1)
mesh = DeviceMesh(dryrun.fake_device(), torch.zeros(1, 1, dtype=torch.int64),
                  mesh_dim_names=("data", "model"))
rec = dryrun.run_cell(cfg, ShapeSpec("train_{length}", "train", {length}, {batch}), "one",
                      mesh=mesh)
print("RESULT " + json.dumps(rec))
"""


def _dryrun_procs():
    """22a's dry run (a fake world of one rank, in its own process) and
    22c's two production cells through the CLI, all started at once."""
    env = dict(os.environ, PYTHONPATH=SRC)
    code = _DRYRUN_ONE_RANK.format(src=SRC, layers=LM_TRAIN_LAYERS, length=LM_TRAIN_LEN,
                                   batch=LM_TRAIN_BATCH)
    procs = {"22a": subprocess.Popen([sys.executable, "-c", code], cwd=REPO, env=env,
                                     text=True, stdout=subprocess.PIPE, stderr=subprocess.PIPE)}
    for arch, shape, mesh in DRYRUN_CELLS:
        procs[f"{arch} {shape} {mesh}"] = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch, "--shape",
             shape, "--mesh", mesh], cwd=REPO, env=env, text=True, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE)
    return procs


def _dryrun_card(torch, timer):
    """22b: 18a's step (zamba2-7b, 12 layers, bf16, B = 2 x 2048, remat,
    AdamW) built by the dry run's ``build_cell`` with real weights on a
    (1, 1) mesh of one NCCL rank, on the plain path: its peak memory
    (``max_memory_allocated`` after a reset, less ``memory_allocated``
    before the weights: what earlier phases left allocated is not the
    step's), ``FlopCounterMode``'s count
    and one profiled step's device time; then the kernel path's peak and
    device time on the same weights, state and batch."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.configs import ShapeSpec, get_arch
    from repro_torch.core import prng
    from repro_torch.launch import dryrun
    from repro_torch.models import init_params
    from repro_torch.optim import adamw, cosine_schedule
    from repro_torch.train import make_accum_train_step

    cfg = dataclasses.replace(get_arch("zamba2-7b"), n_layers=LM_TRAIN_LAYERS)
    shape = ShapeSpec(f"train_{LM_TRAIN_LEN}", "train", LM_TRAIN_LEN, LM_TRAIN_BATCH)
    out = {}
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{_free_port()}", rank=0,
                            world_size=1)
    try:
        mesh = DeviceMesh("cuda", torch.zeros(1, 1, dtype=torch.int64),
                          mesh_dim_names=("data", "model"))
        out["base"] = torch.cuda.memory_allocated()
        params = init_params(cfg, prng.PRNGKey(0, device="cuda"), device="cuda")
        step, args, mb = dryrun.build_cell(cfg, shape, mesh, params=params)
        params, state, batch = args
        del args
        kstep = make_accum_train_step(cfg, adamw(cosine_schedule(3e-4, 2000, 100_000)),
                                      dataclasses.replace(dryrun._opts(mesh), use_flash="auto"),
                                      microbatches=mb)
        for label, fn in (("plain", step), ("kernel", kstep)):
            def run(fn=fn):
                with mesh:
                    return fn(params, state, batch)[1]
            state = run()  # warm-up
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            counter = FlopCounterMode(display=False)
            with counter:
                state = run()
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated()
            dev_ms, n_kern = _device_ms(timer, run)
            out[label] = {"peak": peak - out["base"], "raw_peak": peak,
                          "flops": counter.get_total_flops(),
                          "device_ms": dev_ms, "kernels": n_kern}
        out["total_memory"] = torch.cuda.get_device_properties(0).total_memory
        del params, state, batch, step, kstep
    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache()
    return out


def dryrun_phase(torch, timer):
    """Phase 22: the dry run's predictions against the card.  (a) 18a's
    step dry-run on a fake world of one rank; (b) the same step on the card
    (plain path gated: FLOPs equal, peak within 10%; the kernel path
    beside it); (c) two production cells through the CLI, each ``[ok]``."""
    from repro_torch.launch import dryrun

    start = time.perf_counter()
    procs = _dryrun_procs()
    try:
        card = _dryrun_card(torch, timer)
        results = {}
        for name, proc in procs.items():
            stdout, stderr = proc.communicate(timeout=DRYRUN_TIMEOUT)
            check(proc.returncode == 0, f"22: the dry run {name} failed (rc "
                  f"{proc.returncode}): {stderr[-3000:]}")
            results[name] = stdout
    finally:  # a failed gate above leaves no dry run running
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    line = [x for x in results.pop("22a").splitlines() if x.startswith("RESULT ")]
    check(len(line) == 1, "22a printed no record")
    rec = json.loads(line[0][len("RESULT "):])
    mem, roof, full = rec["memory"], rec["roofline"], rec["full_module_cost"]
    plain, kern = card["plain"], card["kernel"]
    flop_rel = abs(full["flops"] - plain["flops"]) / plain["flops"]
    peak_rel = (mem["total_hbm_bytes"] - plain["peak"]) / plain["peak"]
    bound_ms = max(roof["compute_s"], roof["memory_s"], roof["collective_s"]) * 1e3
    share = {k: "not measured" if v["device_ms"] is None else f"{bound_ms / v['device_ms']:.3f}"
             for k, v in card.items() if k in ("plain", "kernel")}
    gib = 2**30
    print(f"  (a) zamba2-7b bf16, {LM_TRAIN_LAYERS} of 81 layers, B={LM_TRAIN_BATCH} x "
          f"{LM_TRAIN_LEN}, remat, AdamW, dry-run on a fake world of one rank "
          f"({rec['compile_s']} s traced, {rec['total_s']} s in all): {full['flops']:.6e} "
          f"FLOPs (roofline {roof['flops']:.6e}), peak {mem['total_hbm_bytes'] / gib:.3f} "
          f"GiB (arguments {mem['argument_size_in_bytes'] / gib:.3f}, outputs "
          f"{mem['output_size_in_bytes'] / gib:.3f} of which in place "
          f"{mem['alias_size_in_bytes'] / gib:.3f}, temporaries "
          f"{mem['temp_size_in_bytes'] / gib:.3f}); roofline compute {roof['compute_s'] * 1e3:.2f}"
          f" ms, memory {roof['memory_s'] * 1e3:.2f} ms (pre-fusion "
          f"{roof['memory_s_hlo_prefusion'] * 1e3:.2f}, kernel path "
          f"{roof['memory_s_kernel_prefusion'] * 1e3:.2f}), collective "
          f"{roof['collective_s'] * 1e3:.2f} ms, dominant {roof['dominant']}, useful "
          f"{roof['useful_ratio']:.3f}", flush=True)
    print(f"  (b) the same step built by build_cell on a (1, 1) mesh of one NCCL rank: plain "
          f"path {plain['flops']:.6e} FLOPs (FlopCounterMode), predicted/measured - 1 = "
          f"{flop_rel:.2e} (limit {DRYRUN_FLOP_REL:g}); peak {plain['peak'] / gib:.3f} GiB "
          f"above the {card['base'] / gib:.3f} GiB allocated before the weights "
          f"(max_memory_allocated {plain['raw_peak'] / gib:.3f} GiB), predicted/measured - 1 "
          f"= {peak_rel:+.2%} (limit {DRYRUN_PEAK_REL:.0%}); device "
          f"time {plain['device_ms']} ms over {plain['kernels']} kernels, the roofline "
          f"bound {bound_ms:.2f} ms of it: {share['plain']} (observed, not gated); kernel "
          f"path: peak {kern['peak'] / gib:.3f} GiB above the same base, device time {kern['device_ms']} ms over "
          f"{kern['kernels']} kernels (bound {share['kernel']} of it), {kern['flops']:.6e} "
          f"FLOPs counted (the LM kernels' own not among them); "
          f"total_memory {card['total_memory']} bytes (dry run's HBM_BUDGET "
          f"{dryrun.HBM_BUDGET}: equal {card['total_memory'] == dryrun.HBM_BUDGET})",
          flush=True)
    check(flop_rel <= DRYRUN_FLOP_REL, "22b: the predicted FLOPs miss the measured ones")
    check(abs(peak_rel) <= DRYRUN_PEAK_REL, "22b: the predicted peak misses the measured one")
    for (arch, shape, mesh), (name, stdout) in zip(DRYRUN_CELLS, results.items()):
        tags = [x for x in stdout.splitlines() if x.startswith("[")]
        print(f"  (c) python -m repro_torch.launch.dryrun --arch {arch} --shape {shape} "
              f"--mesh {mesh}: {tags[-1] if tags else stdout[-300:]}", flush=True)
        check(len(tags) == 1 and tags[0].startswith(f"[ok] {mesh}"),
              f"22c: {name} did not end [ok]")
        before = DRYRUN_PEAKS_BEFORE.get((arch, shape, mesh))
        if before is not None:
            peak = float(re.search(r"hbm=([0-9.]+)GiB", tags[0]).group(1))
            print(f"      predicted peak a rank {peak:.2f} GiB, {before:.2f} GiB before the "
                  f"vocab-parallel loss and the decode and head layouts (the card: "
                  f"{dryrun.HBM_BUDGET / gib:.2f} GiB); card {card_line()}", flush=True)
            check(peak < before, f"22c: {name}'s predicted peak did not fall")
            if shape.startswith("train"):
                check(peak * gib < dryrun.HBM_BUDGET, f"22c: {name} does not fit the card")
    print(f"  (phase 22 wall, the dry runs beside the card's step: "
          f"{time.perf_counter() - start:.1f} s)", flush=True)


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
    clock = {"phase": None, "start": t_start}
    seconds_by_phase = {}

    def phase(label):
        """Prints the previous phase's seconds, then this phase's heading."""
        now = time.perf_counter()
        if clock["phase"] is not None:
            print(f"  ({clock['phase']}: {now - clock['start']:.1f} s)", flush=True)
            seconds_by_phase[clock["phase"]] = round(now - clock["start"], 1)
        clock.update(phase=label.split(":")[0], start=now)
        if label:
            print(label, flush=True)

    phase("phase 1: device")
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

    phase("phase 2: build")
    from repro_torch.kernels import KERNELS, WILLIAMSON2N, WS_STAGE_DIAG, build_kernels
    seconds = build_kernels()
    print(f"  built {len(KERNELS)} kernel libraries in {seconds:.2f} s", flush=True)
    for k in KERNELS:
        for line in k.build_log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {k.name}: {line.strip()}", flush=True)

    phase("phase 3: kernels against their plain twins")
    timer = Timer(torch)
    stats = kernel_phase(torch, timer)
    rows_kernel_phase(torch, timer, stats)
    stats.update(lm_kernel_phase(torch, timer))
    stats.update(lm_bwd_kernel_phase(torch, timer))
    start = time.perf_counter()
    flash_long_phase(torch, timer)
    print(f"  (the long sequences: {time.perf_counter() - start:.1f} s)", flush=True)

    phase("phase 4: serve requests A-D")
    params, y0, sync_abc = serve_phase(torch, timer)
    ws_launches, ws_replayed = WS_STAGE_DIAG.launches, WS_STAGE_DIAG.replayed_launches

    phase("phase 5: ODE sdeint through williamson2n")
    ode_phase(torch, params)

    launches = {"ws_stage_diag": WS_STAGE_DIAG.launches,
                "williamson2n": WILLIAMSON2N.launches}
    print(f"phase 6: kernels launched on the main path (phases 4-5): "
          f"{launches} (ws_stage_diag {ws_launches} of them while serving, "
          f"{ws_replayed} of those replayed from tick graphs)", flush=True)
    for name, n in launches.items():
        check(n > 0, f"{name} was not launched on the main path")
    check(ws_replayed > 0, "ws_stage_diag was not replayed from a tick graph")

    phase("phase 7: Table 1 on the card")
    train_launches = table1_phase(torch)
    print(f"  kernels launched on the training path (phase 7's 60-epoch runs): "
          f"{train_launches}", flush=True)
    for name in ("ws_stage_diag_bwd", "increment_diag", "axpy_chain",
                 "ws_stage_diag"):
        check(train_launches[name] > 0,
              f"{name} was not launched on the training path")
    launches.update({name: train_launches[name] for name in
                     ("ws_stage_diag_bwd", "increment_diag", "axpy_chain")})

    phase("phase 8: reversible, recursive and full adjoint memory; one step's "
          "profile")
    memory_phase(torch, timer)

    phase("phase 9: serve additive, general and diagonal SDEs (requests E-N)")
    serve_launches, serve_routes = noise_serve_phase(torch, timer)

    phase("phase 10: train on the additive and general terms")
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

    phase("phase 11: LM prefill, zamba2-7b at full width")
    lm_float32_phase(torch)
    cfg, lm_params, prefill_launches = lm_prefill_phase(torch, timer)
    launches.update(prefill_launches)

    phase("phase 12: LM serving, zamba2-7b at full width (bf16)")
    lm_serve_phase(torch, timer, cfg, lm_params)
    del lm_params
    torch.cuda.empty_cache()

    phase("phase 13: the paper's Euclidean experiments (Tables 7 and 2, the "
          "stability frontier)")
    table_launches = paper_tables_phase(torch, timer)
    print(f"  kernels launched on phase 13's paths: {table_launches}", flush=True)

    phase("phase 14: async serving, faults and warmup (requests A-C)")
    async_launches = async_phase(torch, params, y0, sync_abc)
    print(f"  ws_stage_diag launched on phase 14's paths: {async_launches}",
          flush=True)

    phase("phase 15: adaptive solves on Virtual Brownian Trees (requests O, P; "
          "card vs CPU; gradients over a realized grid)")
    adaptive_launches = adaptive_phase(torch, timer, params, y0)
    print(f"  launched on phase 15's paths: {adaptive_launches}", flush=True)
    launches.update({name: adaptive_launches[name] for name in
                     ("ws_stage_diag_rows", "ws_stage_diag_bwd_rows")})
    start = time.perf_counter()
    rows_launches_15d, rows_routes, axpy_15d = per_path_phase(torch, params, y0)
    print(f"  (15d: {time.perf_counter() - start:.1f} s)", flush=True)
    launches.update({f"{name}_rows": n for name, n in rows_launches_15d.items()})
    by_route.update({f"{name}_rows": r for name, r in rows_routes.items()})

    phase("phase 16: scanned training steps, loops and checkpoints (CUDA graphs)")
    pipeline_launches, pipeline_replayed = training_pipeline_phase(torch, timer)
    print(f"  launched on phase 16's paths (eager + replayed): {pipeline_launches}; "
          f"by graph replays: {pipeline_replayed}", flush=True)

    phase("phase 17: manifolds (Tables 3 and 4, Figs 5b and 6, served manifold "
          "requests, Fig 8's SO(3) rates)")
    manifold_launches = manifold_phase(torch, params, y0)
    print(f"  kernels launched on phase 17's paths: {manifold_launches} (no TPU "
          f"kernel lies on the manifold path: the eleven kernels are not launched)",
          flush=True)
    check(not manifold_launches, "phase 17 launched a kernel")

    phase("phase 18: LM training at full width (zamba2-7b's train loop, the kernel "
          "path against the plain path, EES over olmo-1b's depth, the launcher)")
    lm_train_launches = lm_training_phase(torch, timer)
    print(f"  the LM kernels launched on 18a's main path (4 AdamW steps of train_loop's "
          f"default step): {lm_train_launches}", flush=True)
    for name in LM_KERNELS:
        check(lm_train_launches.get(name, 0) > 0,
              f"{name} was not launched on the LM training path")
    launches.update({name: lm_train_launches[name]
                     for name in ("flash_attention_bwd", "ssd_scan_bwd")})

    phase("phase 19: the moe family and the patch / frames frontends at full width "
          "(olmoe-1b-7b, qwen3-moe-30b-a3b, qwen2-vl-2b, hubert-xlarge)")
    p19_launches = moe_frontend_phase(torch, timer)
    print(f"  the attention kernels launched on phase 19's paths: {p19_launches}",
          flush=True)

    phase("phase 20: mesh data parallelism (sharded serving and the Table-1 step on a "
          "world of one NCCL rank; two ranks on the card over gloo)")
    mesh_launches = mesh_phase(torch, params, y0, sync_abc)
    print(f"  launched on 20a-20b's paths: {mesh_launches}", flush=True)

    phase("phase 21: tensor, expert and sequence parallelism of the LM on DTensor (a (1, 1) "
          "mesh of one NCCL rank against no mesh; two ranks on the card over gloo)")
    tp_launches = tp_phase(torch)
    print(f"  the LM kernels launched on 21a's path (the (1, 1) mesh steps): {tp_launches}",
          flush=True)

    phase("phase 22: the dry run against the card (18a's step predicted on a fake world, "
          "then run on the plain path; three production cells through the CLI)")
    dryrun_phase(torch, timer)
    phase("")

    tpu = "src/repro/kernels/sde_step/sde_step.py"
    sources = {"ws_stage_diag": ("ws_stage_diag.cu", f"{tpu}:144"),
               "williamson2n": ("williamson2n.cu",
                                "src/repro/kernels/williamson2n/williamson2n.py:56"),
               "ws_stage_diag_bwd": ("ws_stage_diag_bwd.cu", f"{tpu}:182"),
               "ws_stage_diag_rows": ("ws_stage_diag.cu", f"{tpu}:144"),
               "ws_stage_diag_bwd_rows": ("ws_stage_diag_bwd.cu", f"{tpu}:182"),
               "increment_diag_rows": ("increment_diag.cu", f"{tpu}:65"),
               "increment_pre_rows": ("increment_pre.cu", f"{tpu}:85"),
               "ws_stage_pre_rows": ("ws_stage_pre.cu", f"{tpu}:212"),
               "increment_general_rows": ("increment_general.cu", f"{tpu}:112"),
               "ws_stage_general_rows": ("ws_stage_general.cu", f"{tpu}:247"),
               "increment_diag": ("increment_diag.cu", f"{tpu}:65"),
               "axpy_chain": ("axpy_chain.cu", f"{tpu}:286"),
               "increment_pre": ("increment_pre.cu", f"{tpu}:85"),
               "ws_stage_pre": ("ws_stage_pre.cu", f"{tpu}:212"),
               "increment_general": ("increment_general.cu", f"{tpu}:112"),
               "ws_stage_general": ("ws_stage_general.cu", f"{tpu}:247"),
               "flash_attention": ("flash_attention.cu", "src/repro/kernels/"
                                   "flash_attention/flash_attention.py:119"),
               "ssd_scan": ("ssd_scan.cu", "src/repro/kernels/ssd_scan/ssd_scan.py:84"),
               # the gradients of the reference's plain twins under jax.grad
               "flash_attention_bwd": ("flash_attention_bwd.cu", "src/repro/kernels/"
                                       "flash_attention/ref.py::attention_ref"),
               "ssd_scan_bwd": ("ssd_scan_bwd.cu",
                                "src/repro/kernels/ssd_scan/ref.py::ssd_chunked_ref")}
    record = {"kernels": [
        {"name": name, "route": "cuda",
         "source": f"src/repro_torch/csrc/{sources[name][0]}",
         "replaces": sources[name][1], "launches": launches[name],
         "max_abs_err": stats[name]["max_abs_err"], "ms": stats[name]["ms"],
         "plain_ms": stats[name]["plain_ms"],
         "bound_ms": stats[name]["bound_ms"],
         "bound_by": stats[name]["bound_by"],
         "library_ms": stats[name]["library_ms"],
         **({"launches_by_route": by_route[name]} if name in by_route else {}),
         **({"launches_phase_13": table_launches[name]}
            if name in table_launches else {}),
         **({"launches_phase_14": async_launches}
            if name == "ws_stage_diag" else {}),
         **({"launches_phase_16": pipeline_launches.get(name, 0),
             "replayed_phase_16": pipeline_replayed.get(name, 0)}
            if name in PHASE16_KERNELS else {}),
         **({"launches_phase_18": lm_train_launches[name]}
            if name in ("flash_attention", "ssd_scan") else {}),
         **({"launches_phase_19": p19_launches[name]} if name in p19_launches else {}),
         **({"launches_phase_20": mesh_launches[name]} if name in mesh_launches else {}),
         **({"launches_phase_21": tp_launches[name]} if name in tp_launches else {}),
         **({"launches_phase_15d": axpy_15d} if name == "axpy_chain" else {})}
        for name in sources]}
    print(f"  seconds by phase: {seconds_by_phase}", flush=True)
    print(f"  total {time.perf_counter() - t_start:.1f} s", flush=True)
    print(f"card: {card}", flush=True)
    print(json.dumps(record), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
