"""Training throughput: optimizer steps/s against ``steps_per_call``
chunking (port of ``benchmarks/bench_training.py``).

For each (adjoint x n_paths x microbatches) configuration of the
reference's ``CONFIGS`` it times K sequential steps against one scanned
chunk of the same K steps (:func:`repro_torch.train.make_scanned_step`;
on the card one CUDA graph, captured on the warm-up call and replayed),
which is bitwise the same trajectory, so the comparison is dispatch
accounting alone.  Each call starts from the same parameters and a fresh
optimizer state, as the reference's.  The sizes are the reference's: the
OU term (drift ``nu*(mu - y)``, diagonal diffusion ``sigma``) in dimension
4, EES(2,5), 16 steps, 8 or 32 paths.

``mesh_records`` is the reference's data-parallel ladder over the ranks of
the world (a world of one when the caller started none): per
``MESH_CONFIGS`` entry the single-device step and the sharded step
(``make_sde_train_step(..., mesh=make_train_mesh(), mesh_axis="dp")``)
timed, and whether their parameters and optimizer states came out
bitwise equal; ``mesh_note`` names the world.

Run on the card: ``python -m repro_torch.benchmarks.bench_training
[--out PATH]``; ``--device cpu`` off the GPU.  CSV rows go to stdout; a
file is written only with ``--out`` (never ``BENCH_*.json``).
"""
from __future__ import annotations

import argparse

import torch
from torch import nn

from ..core import prng
from ..core.pytree import tree_leaves
from ..device import resolve_device
from ..optim import adamw, cosine_schedule
from ..train import init_scan_counters, make_scanned_step, make_sde_train_step
from .bench_serving import ou_term
from .common import check_out, device_record, emit, process_world, time_fn, write_out

__all__ = ["CONFIGS", "K_SWEEP", "MESH_CONFIGS", "OUParams", "run", "run_mesh_ladder",
           "mesh_note"]

N_STEPS = 16
DIM = 4
K_SWEEP = (2, 8)
# (adjoint, n_paths, microbatches), the reference's
CONFIGS = (
    ("reversible", 8, 1),
    ("reversible", 32, 1),
    ("reversible", 32, 4),
    ("full", 8, 1),
    ("full", 32, 1),
)
# the reference's mesh ladder: (adjoint, n_paths, microbatches)
MESH_CONFIGS = (("reversible", 32, 1), ("full", 32, 1))
START = {"mu": 0.0, "nu": 0.5, "sigma": 0.5}


class OUParams(nn.Module):
    """The OU term's ``{mu, nu, sigma}`` as a module (float32 scalars)."""

    def __init__(self, device):
        super().__init__()
        for name in sorted(START):
            setattr(self, name, nn.Parameter(
                torch.tensor(START[name], dtype=torch.float32, device=device)))

    def __getitem__(self, name):
        return getattr(self, name)

    def reset(self):
        """Back to the starting values, in place."""
        with torch.no_grad():
            for name in START:
                getattr(self, name).fill_(START[name])


def mesh_note(device: torch.device, world: int) -> str:
    import torch.distributed as dist

    return (f"mesh ladder over a world of {world} rank(s) ({dist.get_backend()} on "
            f"{device.type}); the reference runs it with more than one device")


def run_mesh_ladder(*, device, configs=MESH_CONFIGS, n_steps: int = N_STEPS,
                    dim: int = DIM) -> list:
    """Single-device against sharded steps over every rank of the
    initialised world: times and bitwise parity of the updated state."""
    from ..launch.mesh import make_train_mesh

    term = ou_term()
    opt = adamw(cosine_schedule(1e-3, 2, 1024))
    key = prng.PRNGKey(0, device=device)
    mesh = make_train_mesh(device=device)
    world = mesh.size()
    out = []
    for adjoint, n_paths, microbatches in configs:
        if (n_paths // microbatches) % world:
            continue
        steps, ends = {}, {}
        for kind, kw in (("single", {}), ("sharded", {"mesh": mesh, "mesh_axis": "dp"})):
            step = make_sde_train_step(
                "ees25", term, opt, lambda p: torch.zeros(dim, device=device),
                lambda p, r: torch.mean(r.y_final ** 2), t0=0.0, t1=1.0,
                n_steps=n_steps, n_paths=n_paths, adjoint=adjoint,
                microbatches=microbatches, device=device, **kw)
            params = OUParams(device)

            def one(step=step, params=params):
                params.reset()
                return step(params, opt.init(list(params.parameters())), key)

            p, s, _ = one()
            ends[kind] = [t.detach().clone() for t in tree_leaves((list(p.parameters()), s))]
            steps[kind] = time_fn(one, device, warmup=1, iters=5)
        bitwise = all(torch.equal(a, b) for a, b in zip(ends["single"], ends["sharded"]))
        out.append({
            "adjoint": adjoint, "n_paths": n_paths, "microbatches": microbatches,
            "world_size": world, "us_per_step_single": steps["single"],
            "us_per_step_sharded": steps["sharded"],
            "speedup_vs_single": steps["single"] / steps["sharded"],
            "grads_bitwise_vs_single": bitwise,
        })
        emit(f"bench_training/mesh/{adjoint}/P{n_paths}", steps["sharded"],
             f"world_size={world} bitwise={bitwise}")
    return out


def run(*, device=None, configs=CONFIGS, k_sweep=K_SWEEP, n_steps: int = N_STEPS,
        dim: int = DIM, mesh_configs=MESH_CONFIGS) -> dict:
    device = resolve_device(device)
    term = ou_term()
    opt = adamw(cosine_schedule(1e-3, 2, 1024))
    key = prng.PRNGKey(0, device=device)
    k_max = max(k_sweep)
    records = []
    for adjoint, n_paths, microbatches in configs:
        step = make_sde_train_step(
            "ees25", term, opt, lambda p: torch.zeros(dim, device=device),
            lambda p, r: torch.mean(r.y_final ** 2), t0=0.0, t1=1.0,
            n_steps=n_steps, n_paths=n_paths, adjoint=adjoint,
            microbatches=microbatches, device=device)
        params = OUParams(device)

        def seq_chunk(k_steps=k_max):
            params.reset()
            p, s = params, opt.init(list(params.parameters()))
            for i in range(k_steps):
                p, s, _ = step(p, s, prng.fold_in(key, i))

        us_seq = time_fn(seq_chunk, device, warmup=1, iters=5) / k_max
        tag = f"{adjoint}/P{n_paths}/M{microbatches}"
        for k in k_sweep:
            scanned = make_scanned_step(step, k)

            def scan_chunk():
                params.reset()
                scanned(params, opt.init(list(params.parameters())),
                        init_scan_counters(device), key, 0)

            us_scan = time_fn(scan_chunk, device, warmup=1, iters=5) / k
            speedup = us_seq / us_scan
            records.append({
                "adjoint": adjoint, "n_paths": n_paths,
                "microbatches": microbatches, "n_steps": n_steps, "dim": dim,
                "steps_per_call": k, "graphed": scanned.graphed,
                "capture_s": scanned.chunk.capture_seconds if scanned.graphed else None,
                "us_per_step_sequential": us_seq,
                "us_per_step_scanned": us_scan,
                "steps_per_sec_sequential": 1e6 / us_seq,
                "steps_per_sec_scanned": 1e6 / us_scan,
                "speedup_scan": speedup,
            })
            emit(f"bench_training/{tag}/K{k}", us_scan,
                 f"steps_per_sec={1e6 / us_scan:.1f} speedup_scan={speedup:.2f} "
                 f"graphed={scanned.graphed}")
    with process_world(device) as world:
        mesh_records = run_mesh_ladder(device=device, configs=mesh_configs,
                                       n_steps=n_steps, dim=dim)
        note = mesh_note(device, world)
    print(f"# {note}", flush=True)
    return {
        "device": device_record(device),
        "records": records,
        "speedup_scan_k8": max(r["speedup_scan"] for r in records
                               if r["steps_per_call"] == k_max),
        "mesh_records": mesh_records,
        "mesh_note": note,
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None)
    ap.add_argument("--out", default=None, help="write the JSON payload here")
    ap.add_argument("--n-steps", type=int, default=N_STEPS)
    ap.add_argument("--dim", type=int, default=DIM)
    a = ap.parse_args(argv)
    check_out(a.out)
    write_out(a.out, run(device=a.device, n_steps=a.n_steps, dim=a.dim))


if __name__ == "__main__":
    main()
