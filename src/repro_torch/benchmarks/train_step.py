"""The Table-1 EES(2,5) training step, eager and graphed, against another
checkout's.

Times ``make_sde_train_step("ees25:use_kernels=True", ...)`` at the Table-1
configuration (256 paths, the reversible adjoint, AdamW) as chip_smoke's
phases 7 and 16 run it: ms a step over ``--steps`` eager steps (host wall,
after warm-up steps), the device ms of one step (the profiler's kernels),
and ms a step of a graphed chunk of ``--k`` steps (a replay of
``make_scanned_step``, captured on its first call) with the replay's own
kernel ms and kernels a step.  With ``--baseline
ROOT`` the same measurement runs on the checkout at ``ROOT`` (its
``src/``), each tree in a process of its own, in ``PAIRS`` pairs that
alternate which tree runs first, so a drift of the card or the host
between calls shows; the medians of each tree follow.  CSV rows go to
stdout, then one JSON line of every run.

    python -m repro_torch.benchmarks.train_step [--baseline ROOT] [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

PAIRS = 5

_MEASURE = r"""
import json, sys, time
import torch
from repro_torch.benchmarks import table1_ou as t1
from repro_torch.core import prng
from repro_torch.nsde import init_lsde, lsde_readout, lsde_term, moment_mse
from repro_torch.optim import adamw
from repro_torch.train import init_scan_counters, make_scanned_step, make_sde_train_step

device, steps, k = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
torch.backends.cuda.matmul.allow_tf32 = False
name, spec, n_steps = next(s for s in t1.solvers() if s[1].startswith("ees25"))
tgt = torch.as_tensor(t1.target_paths(), dtype=torch.float32, device=device)


def make():
    params = init_lsde(0, t1.D_OBS, t1.D_Z, t1.WIDTH, device=device)
    opt = adamw(1e-2)
    step = make_sde_train_step(
        spec, lsde_term(), opt,
        y0_fn=lambda p: torch.zeros(t1.D_Z, device=device) + p.encoder.b,
        loss_fn_result=lambda p, r: moment_mse(lsde_readout(p, r.ys)[..., 0], tgt),
        t0=0.0, t1=t1.T, n_steps=n_steps, n_paths=t1.BATCH, adjoint="reversible",
        save_every=n_steps // 2, device=device)
    return step, params, opt.init(list(params.parameters())), prng.PRNGKey(1, device=device)


def sync():
    if device == "cuda":
        torch.cuda.synchronize()


step, params, state, key = make()
for i in range(3):
    params, state, _ = step(params, state, prng.fold_in(key, i))
sync()
start = time.perf_counter()
for i in range(3, 3 + steps):
    params, state, m = step(params, state, prng.fold_in(key, i))
sync()
eager_ms = (time.perf_counter() - start) / steps * 1e3


def device_ms(fn, n_steps):
    # kernel ms a step and kernels a step of fn, from the profiler
    if device != "cuda":
        return None, None
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        sync()
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    us = sum(e.time_range.elapsed_us() for e in kernels)
    return (us / 1e3 / n_steps if us > 0 else None), len(kernels) / n_steps


eager_dev, eager_kernels = device_ms(lambda: step(params, state, prng.fold_in(key, 3 + steps)), 1)
step, params, state, key = make()
scanned = make_scanned_step(step, k)
counters = init_scan_counters(device)
params, state, counters, _ = scanned(params, state, counters, key, 0)
params, state, counters, _ = scanned(params, state, counters, key, k)
sync()
start = time.perf_counter()
chunks = max(1, steps // k)
for c in range(chunks):
    params, state, counters, _ = scanned(params, state, counters, key, (2 + c) * k)
sync()
graph_ms = (time.perf_counter() - start) / (chunks * k) * 1e3
graph_dev, graph_kernels = device_ms(
    lambda: scanned(params, state, counters, key, (2 + chunks) * k), k)
print(json.dumps({"spec": spec, "n_steps": n_steps, "n_paths": t1.BATCH,
                  "eager_ms": eager_ms, "device_ms": eager_dev,
                  "kernels": eager_kernels, "graphed": scanned.graphed,
                  "graph_ms": graph_ms, "graph_device_ms": graph_dev,
                  "graph_kernels": graph_kernels}))
"""


def measure(root: str, device: str, steps: int, k: int) -> dict:
    """One tree's numbers, measured in a process of its own."""
    env = dict(os.environ, PYTHONPATH=os.path.join(os.path.abspath(root), "src"))
    proc = subprocess.run([sys.executable, "-c", _MEASURE, device, str(steps), str(k)],
                          env=env, capture_output=True, text=True, timeout=1800)
    if proc.returncode != 0:
        raise RuntimeError(f"the measurement of {root} failed: {proc.stderr[-3000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--baseline", default=None, help="root of another checkout")
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--k", type=int, default=8)
    a = ap.parse_args(argv)
    here = os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))
    trees = [("this", here)]
    if a.baseline:
        pair = [("baseline", a.baseline), ("this", here)]
        trees = [t for i in range(PAIRS) for t in (pair if i % 2 == 0 else pair[::-1])]
    runs = []
    for label, root in trees:
        r = dict(measure(root, a.device, a.steps, a.k), tree=label)
        runs.append(r)
        print(f"train_step/{label},{r['eager_ms'] * 1e3:.1f},eager_ms={r['eager_ms']:.3f} "
              f"device_ms={r['device_ms']} kernels={r['kernels']} graphed={r['graphed']} "
              f"graph_ms={r['graph_ms']:.3f} graph_device_ms={r['graph_device_ms']} "
              f"graph_kernels={r['graph_kernels']}", flush=True)
    for label in dict(trees):
        mine = [r for r in runs if r["tree"] == label]
        med = {m: statistics.median(r[m] for r in mine)
               for m in ("eager_ms", "device_ms", "graph_ms", "graph_device_ms")
               if mine[0][m] is not None}
        print(f"# {label}: medians of {len(mine)} runs {med}", flush=True)
    print(json.dumps(runs), flush=True)


if __name__ == "__main__":
    main()
