"""Benchmark suite entry point — one module per paper table/figure.

Port of ``benchmarks/run.py``: runs the seven suite modules in the
reference's order, each printing ``name,us_per_call,derived`` CSV rows (a
module's own lines too), with a module that raises reported as an
``ERROR`` row while the suite goes on:

  table7_gbm       — Table 7/H.1: stiff-GBM stability separation
  table1_ou        — Table 1: high-vol OU stability under training
  table2_vol       — Table 2/H.2: runtime at fixed NFE (2N recurrence win)
  table3_kuramoto  — Table 3 + Fig 5b: T*T^N energy score + adjoint memory
  table4_sphere    — Table 4 + Fig 6: sphere latent SDE + adjoint memory
  fig_convergence  — Figs 7/8 + App. G: strong/backward rates on fBm RDEs
  bench_throughput — beyond-paper: batched sdeint trajectories/sec vs batch

Run ``python -m repro_torch.benchmarks.run`` (``--device cpu`` off the GPU;
the whole suite takes tens of minutes there).
"""
import argparse
import time
import traceback


def main(argv=None) -> None:
    from . import (bench_throughput, fig_convergence, table1_ou, table2_vol, table3_kuramoto,
                   table4_sphere, table7_gbm)

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None)
    a = ap.parse_args(argv)
    t00 = time.time()
    for mod in (table7_gbm, table1_ou, table2_vol, table3_kuramoto,
                table4_sphere, fig_convergence, bench_throughput):
        name = mod.__name__.split(".")[-1]
        print(f"# --- {name} ---", flush=True)
        t0 = time.time()
        try:
            mod.main(["--device", a.device] if a.device else [])
        except Exception:  # noqa: BLE001 — keep the suite going
            print(f"{name},nan,ERROR", flush=True)
            traceback.print_exc()
        print(f"# {name} took {time.time()-t0:.1f}s", flush=True)
    print(f"# total {time.time()-t00:.1f}s")


if __name__ == "__main__":
    main()
