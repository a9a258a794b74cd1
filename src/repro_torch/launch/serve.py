"""Serving launcher: batched continuous decoding of an LM smoke config
(port of ``repro.launch.serve``)::

    python -m repro_torch.launch.serve --arch zamba2-7b --requests 8
    python -m repro_torch.launch.serve --arch qwen3-1.7b --device cpu

It runs on the GPU unless given ``--device cpu``.
"""
import argparse
import time

import torch

from repro_torch.configs import get_arch
from repro_torch.models import init_params
from repro_torch.serving.engine import Engine, ServeConfig


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=64)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_arch(args.arch).smoke()
    params = init_params(cfg, 0, device=args.device)
    eng = Engine(cfg, params, ServeConfig(slots=args.slots, max_len=args.max_len))
    if eng.device.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.time()
    for i in range(args.requests):
        eng.submit([2 + i % 50, 7, 11])
    done = eng.run()
    n_tok = sum(len(v) for v in done.values())
    dt = time.time() - t0
    print(f"served {len(done)} requests, {n_tok} tokens in {dt:.1f}s "
          f"({n_tok/dt:.1f} tok/s on {eng.device.type}, smoke config)")


if __name__ == "__main__":
    main()
