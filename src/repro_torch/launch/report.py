"""Render the dry run's tables from launch_results_torch/ JSON records
(port of ``repro.launch.report``)::

    python -m repro_torch.launch.report [--mesh single] [--variant v2] [--md]

The times are predictions from the H100's datasheet constants
(:mod:`repro_torch.launch.roofline`), not measurements.
"""
import argparse
import glob
import json
import os

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                           "launch_results_torch")


def load(mesh: str, variant: str):
    recs = []
    pat = os.path.join(os.path.abspath(RESULTS_DIR), mesh, f"*__{variant}.json")
    for path in sorted(glob.glob(pat)):
        with open(path) as f:
            recs.append(json.load(f))
    return recs


def fmt_row(r):
    if r["status"] == "skipped":
        return (r["arch"], r["shape"], "skip", r.get("reason", ""), "", "", "", "", "", "")
    if r["status"] != "ok":
        return (r["arch"], r["shape"], "ERR", r.get("error", "")[:40], "", "", "", "", "", "")
    roof = r.get("roofline", {})
    mem = r["memory"]
    return (
        r["arch"],
        r["shape"],
        "ok",
        f"{mem['total_hbm_bytes']/2**30:.1f}",
        "Y" if r.get("fits_hbm") else "N",
        f"{roof.get('compute_s', 0)*1e3:.1f}",
        f"{roof.get('memory_s', 0)*1e3:.1f}",
        f"{roof.get('collective_s', 0)*1e3:.1f}",
        roof.get("dominant", "?")[:4],
        f"{roof.get('useful_ratio') or 0:.2f}",
    )


HDR = ("arch", "shape", "st", "HBM(GiB)", "fit", "comp(ms)", "mem(ms)", "coll(ms)",
       "dom", "useful")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", default="single")
    ap.add_argument("--variant", default="v2")
    ap.add_argument("--md", action="store_true")
    args = ap.parse_args(argv)
    recs = load(args.mesh, args.variant)
    rows = [fmt_row(r) for r in recs]
    if args.md:
        print("| " + " | ".join(HDR) + " |")
        print("|" + "---|" * len(HDR))
        for row in rows:
            print("| " + " | ".join(str(x) for x in row) + " |")
    else:
        w = [max(len(str(r[i])) for r in rows + [HDR]) for i in range(len(HDR))]
        print("  ".join(h.ljust(w[i]) for i, h in enumerate(HDR)))
        for row in rows:
            print("  ".join(str(x).ljust(w[i]) for i, x in enumerate(row)))
    ok = [r for r in recs if r["status"] == "ok"]
    fits = [r for r in ok if r.get("fits_hbm")]
    print(f"\n{args.mesh}/{args.variant}: {len(ok)} ok, "
          f"{sum(1 for r in recs if r['status']=='skipped')} skipped (documented), "
          f"{len(ok)-len(fits)} over HBM budget")


if __name__ == "__main__":
    main()
