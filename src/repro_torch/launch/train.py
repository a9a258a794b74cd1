"""Training launcher (port of ``repro.launch.train``)::

    python -m repro_torch.launch.train --arch olmo-1b --steps 100
    python -m repro_torch.launch.train --arch zamba2-7b --steps 4 --device cpu

It trains the architecture's reduced smoke config (``--smoke`` is always
on, as in the reference) on the synthetic token stream with AdamW on a
cosine schedule, each layer rematerialised in the backward, through
``train_loop``'s default step.  It runs on the GPU unless given ``--device
cpu``.  With ``--microbatches M`` each batch of ``--batch`` rows is split
into M microbatches of ``batch / M`` rows.

``--mesh DATAxMODEL`` trains on a ``("data", "model")`` mesh of DATA x MODEL
ranks, one process each (tensor, expert and data parallelism: the
reference's rules place the parameters, ``ShardingPolicy(batch_axes=
("data",), model_axis="model")`` lays out the activations).  Start every
rank with the same arguments and its own ``--rank``; they meet at
``--init-method`` (NCCL on the GPU, gloo on the CPU)::

    python -m repro_torch.launch.train --arch qwen3-1.7b --steps 4 \
        --device cpu --mesh 2x2 --rank R --init-method tcp://127.0.0.1:29500
"""
import argparse

import torch

from repro_torch.configs import get_arch
from repro_torch.core.pytree import tree_map
from repro_torch.data.pipeline import DataConfig, SyntheticTokens
from repro_torch.models import ModelOptions, ShardingPolicy, init_params
from repro_torch.optim import adamw, cosine_schedule
from repro_torch.train.trainer import TrainLoopConfig, train_loop


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--steps-per-call", type=int, default=1,
                    help="optimizer steps per dispatch (a chunk of steps; "
                         "bitwise the sequential steps)")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--mesh", default=None, metavar="DATAxMODEL",
                    help="train on a (data, model) mesh of that many ranks")
    ap.add_argument("--rank", type=int, default=0)
    ap.add_argument("--init-method", default="tcp://127.0.0.1:29500")
    args = ap.parse_args(argv)

    cfg = get_arch(args.arch)
    if args.smoke:
        cfg = cfg.smoke()
    if args.mesh is not None and args.device.startswith("cuda"):
        torch.cuda.set_device(args.rank % torch.cuda.device_count())  # a card a rank
    params = init_params(cfg, 0, device=args.device)
    n_params = sum(p.numel() for p in params.parameters())
    print(f"arch={cfg.name} params={n_params/1e6:.1f}M device={args.device}")
    if args.mesh is None:
        return _train(args, cfg, params, ModelOptions(remat=True))

    import torch.distributed as dist

    from repro_torch.launch.mesh import param_shardings, place
    from torch.distributed.device_mesh import DeviceMesh

    shape = tuple(int(n) for n in args.mesh.lower().split("x"))
    device = next(params.parameters()).device
    backend = "nccl" if device.type == "cuda" else "gloo"
    dist.init_process_group(backend, init_method=args.init_method, rank=args.rank,
                            world_size=shape[0] * shape[1])
    try:
        mesh = DeviceMesh(device.type, torch.arange(shape[0] * shape[1]).reshape(shape),
                          mesh_dim_names=("data", "model"))
        place(params, param_shardings(mesh, params))
        opts = ModelOptions(remat=True, shard=ShardingPolicy(batch_axes=("data",),
                                                             model_axis="model"))
        with mesh:
            _train(args, cfg, params, opts)
    finally:
        dist.destroy_process_group()


def _train(args, cfg, params, opts):
    data = SyntheticTokens(DataConfig(args.batch, args.seq, cfg.vocab))
    device = next(params.parameters()).device
    mb = max(args.microbatches, 1)

    def to_device(batch):
        # (..., batch, seq) leaves, a chunk's stacked steps leading, as
        # (..., microbatches, batch / microbatches, seq)
        def move(x):
            t = torch.as_tensor(x, device=device)
            if mb == 1:
                return t
            *lead, rows, seq = t.shape
            return t.reshape(*lead, mb, rows // mb, seq)
        return tree_map(move, batch)

    out = train_loop(
        cfg,
        params,
        data,
        optimizer=adamw(cosine_schedule(args.lr, 10, args.steps)),
        opts=opts,
        loop=TrainLoopConfig(
            steps=args.steps,
            ckpt_dir=args.ckpt_dir,
            ckpt_every=max(args.steps // 2, 1),
            microbatches=mb,
            log_every=max(args.steps // 10, 1),
            steps_per_call=args.steps_per_call,
        ),
        to_device=to_device,
    )
    for step, loss in out["losses"]:
        print(f"step {step:5d}  loss {loss:.4f}")
    print(f"wall: {out['wall_s']:.1f}s  dispatches: {out['n_dispatches']}")


if __name__ == "__main__":
    main()
