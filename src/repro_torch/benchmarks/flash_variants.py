"""Design variants of ``flash_attention``'s wgmma route, timed on the card.

Each variant is the committed ``csrc/flash_attention.cu`` with one change,
built into its own library:

* ``committed`` — as shipped;
* ``p_single_bf16`` — O += P V with P rounded to one bf16 part (the hi
  part alone), one wgmma pass over V instead of two;
* ``mask_every_tile`` — the causal/ragged mask evaluated on every KV tile,
  and ``exp2f`` in place of the SFU's ``ex2.approx.ftz``;
* ``three_stages`` — a K/V ring of three stages instead of two (230 KB of
  shared memory).

For each it prints, per shape, the worst ``|got - want| / (8e-3 |want| +
1e-3)`` against the plain twin (the bf16 bound of ``chip_smoke.py`` phase 3
is 1) and the device time of one call (CUDA events around each call, the
calls queued behind a sleep so host launch time is not counted; median of
15 calls in each of two rounds, variants in turns; L2 flushed, then
warm).  Shapes:
zamba2-7b's (2, 32, 32, 2048, 112) and qwen3-1.7b's (1, 16, 8, 2048, 128)
causal, and a ragged (2, 4, 2, 200, 112).  Needs ``nvcc`` and a card::

    PYTHONPATH=src python -m repro_torch.benchmarks.flash_variants
"""
from __future__ import annotations

import subprocess

import torch

from ..kernels._build import BUILD_DIR, CSRC_DIR, CudaKernel, build_all, pointer, stream_handle
from ..kernels.flash_attention.flash_attention import _ARGS
from ..kernels.flash_attention.ref import attention_ref

__all__ = ["VARIANTS", "SHAPES", "run"]

_P_LO_PASS = "for (int kk = 0; kk < kWgBlockK / 16; ++kk)\n        wgmma_rs(acc_o, p_lo[kk],"
VARIANTS = {
    "committed": [],
    "p_single_bf16": [(_P_LO_PASS, _P_LO_PASS.replace("kk < kWgBlockK / 16", "kk < 0"))],
    "mask_every_tile": [("if (t == n_tiles - 1) {", "if (true) {"),
                        (" = exp2_ftz(", " = exp2f(")],
    "three_stages": [("constexpr int kWgStages = 2;", "constexpr int kWgStages = 3;")],
}
SHAPES = ((2, 32, 32, 2048, 112, True), (1, 16, 8, 2048, 128, True),
          (2, 4, 2, 200, 112, True))
_ENTRY = "flash_attention_bf16_wgmma"


def _kernels():
    """One CudaKernel per variant, its source written under the build dir."""
    source = (CSRC_DIR / "flash_attention.cu").read_text()
    (BUILD_DIR / "variants").mkdir(parents=True, exist_ok=True)
    kernels = {}
    for name, edits in VARIANTS.items():
        text = source
        for old, new in edits:
            if old not in text:
                raise ValueError(f"variant {name}: {old!r} is not in the source")
            text = text.replace(old, new)
        path = BUILD_DIR / "variants" / f"flash_attention_{name}.cu"
        path.write_text(text)
        kernels[name] = CudaKernel(f"flash_{name}", path, {_ENTRY: _ARGS})
    return kernels


def _call(kernel, q, k, v, causal):
    b, hq, sq, d = q.shape
    out = torch.empty_like(q)
    kernel.launch(_ENTRY, pointer(q), pointer(k), pointer(v), pointer(out), b, hq,
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


def run() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("flash_variants times the CUDA kernel: no card here")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True)
    print(f"card: {card.stdout.strip()}", flush=True)
    kernels = _kernels()
    print(f"built {len(kernels)} variants in {build_all(kernels.values()):.2f} s", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(15)
    flush_buf = torch.empty(64 * 2**20, device="cuda")
    print("variant,shape,worst_ratio,flushed_us,warm_us", flush=True)
    for b, hq, hkv, s, d, causal in SHAPES:
        q = torch.randn(b, hq, s, d, generator=gen, device="cuda").bfloat16()
        k, v = (torch.randn(b, hkv, s, d, generator=gen, device="cuda").bfloat16()
                for _ in range(2))
        want = attention_ref(q, k, v, causal=causal).float()
        times = {name: {True: [], False: []} for name in kernels}
        order = list(kernels) + list(kernels)[::-1]
        for name in order:
            for flush in (True, False):
                fn = lambda: _call(kernels[name], q, k, v, causal)  # noqa: E731
                fn()
                times[name][flush] += _times_us(fn, flush_buf, flush)
        for name, kernel in kernels.items():
            got = _call(kernel, q, k, v, causal).float()
            ratio = ((got - want).abs() / (8e-3 * want.abs() + 1e-3)).max().item()
            med = {f: sorted(t)[len(t) // 2] for f, t in times[name].items()}
            print(f"{name},{(b, hq, hkv, s, d)},{ratio:.3f},{med[True]:.2f},"
                  f"{med[False]:.2f}", flush=True)


if __name__ == "__main__":
    run()
