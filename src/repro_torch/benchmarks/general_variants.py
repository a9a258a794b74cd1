"""Design variants of the general-noise kernels ``increment_general`` and
``ws_stage_general``, timed on the card beside ``torch.baddbmm`` and
``torch.einsum``.

Each variant is the committed ``csrc/row_matvec.cuh`` (the matvec both
kernels share) with one change to its staged route, built with each
kernel's source into libraries of its own:

* ``committed`` — as shipped: 128 outputs a tile, chunks of 128 bytes a row
  copied by TMA (a 2-D tensor map over g as (N*d, m) and one over dW,
  128-byte swizzle, ``mbarrier`` completion) into a ring of 3 stages, the
  grid capped at the blocks resident on the card, each walking tiles;
* ``cp_async_padded`` — chunks copied by ``cp.async``, 16 bytes a thread,
  into rows padded by 16 bytes;
* ``stages_2``, ``stages_4`` — a ring of 2 or 4 stages;
* ``rows_256`` — 256 outputs a tile (256 threads a block);
* ``one_tile_per_block`` — one block per tile, no walk;
* ``row`` — the committed row route (one thread per output), at every m;
* ``baseline`` (with ``--baseline ROOT``) — the kernels of another
  checkout at ``ROOT``, e.g. the parent commit's unpacked tree, as they are
  (its C entries ``<name>_f32`` / ``_f64``).

At N*d = 1,048,576 outputs (N = 65,536 paths of d = 16) with m = 4, 8, 16,
32, 128, 256 in float32 and m = 128 in float64 it prints one CSV row per
kernel and variant, and for ``increment_general`` one for
``torch.baddbmm(f[..., None], g, dW[..., None], beta=h)`` (the same
function) and one for ``torch.einsum("...dm,...m->...d", g, dW)`` (the plain
route's product, without ``f*h``); ``ws_stage_general`` has no single
PyTorch call, and ``baddbmm`` is the yardstick of its product part.  Each
row: device us per call with the L2 flushed and warm (CUDA events around
each call, queued behind a sleep so host launch time stays off the clock;
median of 15 calls in each of two rounds, the calls in turns), the byte
bound (each input read once and each output written once at 3.35 TB/s),
the flushed share of it, and whether the output equals the plain twin
bitwise (at that shape and at the ragged (1001, 16, 132) and (1001, 5,
132)).  A variant that cannot launch at a shape prints its error in place
of its times.  Then the host us per call (back to back) of the wrappers at
N*d = 4,096 outputs, m = 4 (row route) and m = 128 (staged route), each
tree's in a process of its own, this tree and the baseline in turns, twice;
and of each variant's C entry at m = 128 (a TMA launch encodes two tensor
maps).  With ``--baseline`` it also says whether the row-route kernels'
SASS (``cuobjdump -sass``) is the baseline's, instruction for instruction.
No file is written.  Needs ``nvcc`` and a card::

    PYTHONPATH=src python -m repro_torch.benchmarks.general_variants [--baseline ROOT]
"""
from __future__ import annotations

import argparse
import inspect
import json
import re
import subprocess
import sys
from pathlib import Path

import torch

from ..kernels._build import BUILD_DIR, CSRC_DIR, CudaKernel, build_all, stream_handle
from ..kernels.sde_step import ref as sref
from ..kernels.sde_step.sde_step import INCREMENT_GENERAL, WS_STAGE_GENERAL
from .flash_variants import _times_us
from .stream_variants import _edit, host_us_per_call

__all__ = ["VARIANTS", "WIDTHS", "edited_header", "run"]

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
D, PATHS = 16, 65536       # N*d = 1,048,576 outputs
WIDTHS = ((torch.float32, 4), (torch.float32, 8), (torch.float32, 16),
          (torch.float32, 32), (torch.float32, 128), (torch.float32, 256),
          (torch.float64, 128))
RAGGED = ((1001, 16, 132), (1001, 5, 132))
H, A, B = 0.25, -0.6, 0.9

# Edits of csrc/row_matvec.cuh, one design choice of the staged route each.
VARIANTS = {
    "committed": [],
    "cp_async_padded": [("constexpr bool kTmaStaging = true; ",
                         "constexpr bool kTmaStaging = false;")],
    "stages_2": [("constexpr int kStages = 3;", "constexpr int kStages = 2;")],
    "stages_4": [("constexpr int kStages = 3;", "constexpr int kStages = 4;")],
    "rows_256": [("constexpr int kStagedRows = 128;", "constexpr int kStagedRows = 256;")],
    "one_tile_per_block": [("constexpr bool kCappedGrid = true;",
                            "constexpr bool kCappedGrid = false;")],
}
_NAMES = ("increment_general", "ws_stage_general")
_KERNELS = {"increment_general": INCREMENT_GENERAL, "ws_stage_general": WS_STAGE_GENERAL}
_SFX = {torch.float32: "f32", torch.float64: "f64"}


def edited_header(variant: str) -> str:
    """The committed ``row_matvec.cuh`` with ``variant``'s edits applied."""
    return _edit((CSRC_DIR / "row_matvec.cuh").read_text(), VARIANTS[variant], variant)


def _variant_kernels(baseline):
    """{variant: {kernel name: CudaKernel}}: each kernel's source with its
    variant's header inlined, written under the build dir (the other headers
    come from ``csrc/``); the baseline's sources as they are."""
    out_dir = BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    built = {}
    for variant in VARIANTS:
        header = edited_header(variant)
        built[variant] = {}
        for name in _NAMES:
            text = (CSRC_DIR / f"{name}.cu").read_text()
            path = out_dir / f"{name}_{variant}.cu"
            path.write_text(text.replace('#include "row_matvec.cuh"', header))
            built[variant][name] = CudaKernel(f"general_{variant}_{name}", path,
                                              _KERNELS[name].functions)
    if baseline is not None:
        csrc = Path(baseline).resolve() / "src" / "repro_torch" / "csrc"
        built["baseline"] = {
            name: CudaKernel(f"general_baseline_{name}", csrc / f"{name}.cu",
                             {f"{name}_{sfx}": _KERNELS[name].functions[f"{name}_{sfx}"]
                              for sfx in ("f32", "f64")})
            for name in _NAMES}
    return built


def _staged_regs(kernel) -> str:
    """Registers of the staged kernel's float32 32-bit-index instantiation,
    from the ptxas -v log."""
    entry = None
    for line in kernel.build_log.splitlines():
        if "Compiling entry function" in line:
            entry = line
        elif entry and "_staged" in entry and "IfjE" in entry and "registers" in line:
            return re.search(r"Used (\d+) registers", line).group(1)
    return "?"


def _row_sass(kernel, name) -> dict:
    """{template arguments: SASS} of the row-route kernel ``name`` in a built
    library (``cuobjdump -sass``), keyed without the mangled namespace, which
    differs between source files; runs of blanks are one space (the listing
    pads its columns to the longest function name)."""
    from ..kernels._build import _nvcc

    tool = Path(_nvcc()).parent / "cuobjdump"
    out = subprocess.run([str(tool), "-sass", str(kernel.library_path())],
                         capture_output=True, text=True, check=True).stdout
    funcs = {}
    for block in out.split("Function : ")[1:]:
        head, _, body = block.partition("\n")
        found = re.search(rf"{name}_kernel(I\w+?E)", head)
        if found and "_staged" not in head:
            funcs[found.group(1)] = "\n".join(
                " ".join(line.split()) for line in body.split("......")[0].splitlines())
    return funcs


def _inputs(gen, rows, d, m, dtype):
    draw = lambda *s: torch.randn(*s, generator=gen, device="cuda", dtype=dtype)  # noqa: E731
    return draw(rows, d), draw(rows, d), draw(rows, d), draw(rows, d, m), draw(rows, m)


def _launch(kernel, name, entry, xs, outs):
    delta, y, f, g, dW = xs
    rows, d, m = g.shape
    if name == "increment_general":
        kernel.launch(entry, f.data_ptr(), g.data_ptr(), dW.data_ptr(), outs[0].data_ptr(),
                      rows, d, m, H, stream_handle(f))
    else:
        kernel.launch(entry, delta.data_ptr(), y.data_ptr(), f.data_ptr(), g.data_ptr(),
                      dW.data_ptr(), outs[0].data_ptr(), outs[1].data_ptr(), rows, d, m,
                      H, A, B, stream_handle(f))


def _calls(built, name, dtype):
    """{label: (CudaKernel, entry)} of every kernel version of ``name``."""
    sfx = _SFX[dtype]
    calls = {v: (kerns[name], f"{name}_{sfx}_staged")
             for v, kerns in built.items() if v != "baseline"}
    calls["row"] = (built["committed"][name], f"{name}_{sfx}")
    if "baseline" in built:
        calls["baseline"] = (built["baseline"][name], f"{name}_{sfx}")
    return calls


def _twin(name, xs):
    delta, y, f, g, dW = xs
    if name == "increment_general":
        return (sref.increment_general_ref(f, g, dW, H),)
    return sref.ws_stage_general_ref(delta, y, f, g, dW, H, A, B)


def _bitwise(calls, name, xs):
    """{label: True/False, or the launch error} against the twin."""
    want = _twin(name, xs)
    got = {}
    for label, (kern, entry) in calls.items():
        outs = [torch.full_like(want[0], float("nan")) for _ in want]
        try:
            _launch(kern, name, entry, xs, outs)
            torch.cuda.synchronize()
        except RuntimeError as exc:
            got[label] = f"error: {exc}"
            continue
        got[label] = all(torch.equal(o, w) for o, w in zip(outs, want))
    return got


def _bytes(name, rows, d, m, itemsize):
    state = 1 + 1 if name == "increment_general" else 3 + 2  # reads + writes of (N, d)
    return (rows * d * m + rows * m + state * rows * d) * itemsize


def run(baseline=None) -> None:
    if not torch.cuda.is_available():
        raise SystemExit("general_variants times the CUDA kernels: no card here")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True)
    print(f"card: {card.stdout.strip()}", flush=True)
    built = _variant_kernels(baseline)
    libs = [k for kernels in built.values() for k in kernels.values()]
    print(f"built {len(libs)} libraries in {build_all(libs):.2f} s", flush=True)
    for variant in VARIANTS:
        print(f"ptxas,{variant},staged float32 registers "
              f"{_staged_regs(built[variant]['increment_general'])}", flush=True)
    if baseline is not None:
        for name in _NAMES:
            ours = _row_sass(built["committed"][name], name)
            theirs = _row_sass(built["baseline"][name], name)
            print(f"sass,{name},row-route kernels {sorted(ours)} identical to the "
                  f"baseline's: {ours == theirs}", flush=True)
            for key in sorted(ours):
                a, b = ours[key].splitlines(), theirs.get(key, "").splitlines()
                diff = [(x.strip(), y.strip()) for x, y in zip(a, b) if x != y]
                if diff or len(a) != len(b):
                    print(f"sass,{name}{key},{len(a)} against {len(b)} lines, "
                          f"{len(diff)} differ; first: {diff[:2]}", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(19)
    flush_buf = torch.empty(64 * 2**20, device="cuda")
    ragged_ok = {}
    for dtype in (torch.float32, torch.float64):
        for rows, d, m in RAGGED:
            xs = _inputs(gen, rows, d, m, dtype)
            for name in _NAMES:
                for label, ok in _bitwise(_calls(built, name, dtype), name, xs).items():
                    ragged_ok[(name, label)] = ragged_ok.get((name, label), True) and ok is True
    print("kernel,dtype,m,variant,bitwise,flushed_us,warm_us,bound_us,share_flushed",
          flush=True)
    for dtype, m in WIDTHS:
        xs = _inputs(gen, PATHS, D, m, dtype)
        delta, y, f, g, dW = xs
        for name in _NAMES:
            calls = _calls(built, name, dtype)
            exact = _bitwise(calls, name, xs)
            want = _twin(name, xs)
            outs = [torch.empty_like(want[0]) for _ in want]
            fns = {label: (lambda k=kern, e=entry: _launch(k, name, e, xs, outs))
                   for label, (kern, entry) in calls.items() if exact[label] in (True, False)}
            fns["torch.baddbmm" if name == "increment_general"
                else "torch.baddbmm (product part)"] = (
                lambda: torch.baddbmm(f[..., None], g, dW[..., None], beta=H))
            if name == "increment_general":
                fns["torch.einsum (product)"] = (
                    lambda: torch.einsum("...dm,...m->...d", g, dW))
            times = {label: {True: [], False: []} for label in fns}
            for label in list(fns) + list(fns)[::-1]:
                for flush in (True, False):
                    fns[label]()
                    times[label][flush] += _times_us(fns[label], flush_buf, flush)
            bound = _bytes(name, PATHS, D, m, g.element_size()) / HBM_BYTES_PER_S * 1e6
            for label in list(calls) + [k for k in fns if k not in calls]:
                ok = exact.get(label, "")
                if ok is True or ok is False:
                    ok = ok and ragged_ok.get((name, label), True)
                if label not in fns:
                    print(f"{name},{str(dtype)[6:]},{m},{label},{ok},,,{bound:.2f},", flush=True)
                    continue
                med = {fl: sorted(t)[len(t) // 2] for fl, t in times[label].items()}
                print(f"{name},{str(dtype)[6:]},{m},{label},{ok},{med[True]:.2f},"
                      f"{med[False]:.2f},{bound:.2f},{bound / med[True]:.1%}", flush=True)
            del outs, want
        del xs, delta, y, f, g, dW
    print("host,n_outputs,m,call,host_us", flush=True)
    src = Path(__file__).resolve().parents[2]
    trees = [("this tree", src)]
    if baseline is not None:
        trees.append(("baseline", Path(baseline).resolve() / "src"))
    for label, root in trees + trees:  # in turns, twice
        for call, us in _host_row(root).items():
            print(f"host,4096,{call},{label} (wrapper),{us:.2f}", flush=True)
    xs = _inputs(gen, 4096 // D, D, 128, torch.float32)
    outs = [torch.empty_like(xs[2])]
    for label, (kern, entry) in _calls(built, "increment_general", torch.float32).items():
        us = host_us_per_call(lambda k=kern, e=entry: _launch(k, "increment_general", e, xs,
                                                              outs))
        print(f"host,4096,128,{label} {entry} (C entry),{us:.2f}", flush=True)


_HOST_SCRIPT = """
import json, sys, time, torch
sys.path.insert(0, sys.argv[1])
from repro_torch.kernels.sde_step.sde_step import increment_general, ws_stage_general
{timer}
gen = torch.Generator(device="cuda").manual_seed(4)
out = {{}}
for m in (4, 128):
    delta, y, f = (torch.randn(256, 16, generator=gen, device="cuda") for _ in range(3))
    g = torch.randn(256, 16, m, generator=gen, device="cuda")
    dW = torch.randn(256, m, generator=gen, device="cuda")
    out[f"{{m}},increment_general"] = host_us_per_call(lambda: increment_general(f, g, dW, 0.25))
    out[f"{{m}},ws_stage_general"] = host_us_per_call(
        lambda: ws_stage_general(delta, y, f, g, dW, 0.25, a=-0.6, b=0.9))
print(json.dumps(out))
"""


def _host_row(src: Path):
    """Host us per call of the general-noise wrappers of the package under
    ``src`` at 4,096 outputs (256 paths of d = 16), m = 4 and 128, timed by
    :func:`host_us_per_call` in a process of their own."""
    code = _HOST_SCRIPT.format(timer=inspect.getsource(host_us_per_call))
    proc = subprocess.run([sys.executable, "-c", code, str(src)],
                          capture_output=True, text=True, timeout=900)
    if proc.returncode != 0:
        raise RuntimeError(f"host timing under {src} failed:\n{proc.stderr}")
    return json.loads(proc.stdout.strip().splitlines()[-1])

if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--baseline", help="root of another checkout whose "
                        "increment_general.cu and ws_stage_general.cu are timed beside these")
    run(parser.parse_args().baseline)
