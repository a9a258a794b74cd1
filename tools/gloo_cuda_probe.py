"""Which collectives gloo runs on CUDA tensors, one pair of processes per
collective (a crash takes down only its own pair).

    python tools/gloo_cuda_probe.py

Two ranks share card 0 (NCCL refuses two ranks on one device, so gloo is
the multi-rank backend of a one-card machine).  Each case runs the raw
``torch.distributed`` collective or a DTensor redistribution on a (1, 2)
``("data", "model")`` mesh; a line per case gives its result and the
ranks' exit codes (-11: the process was killed by SIGSEGV, its Python
stack printed by ``faulthandler``).  ``repro_torch.spmd`` gathers shards
by an all-reduce on such a mesh because DTensor's Shard -> Replicate
(the functional ``all_gather_into_tensor``) is one that crashes on torch
2.11.
"""
import faulthandler
import socket
import subprocess
import sys

CASES = ("all_reduce", "all_reduce_avg", "all_gather_into_tensor", "reduce_scatter_tensor",
         "all_to_all_single", "functional_all_gather", "dtensor_partial_to_replicate",
         "dtensor_partial_to_shard", "dtensor_shard_to_replicate", "dtensor_shard0_to_shard1")


def _case(name, rank, port):
    import torch
    import torch.distributed as dist

    faulthandler.enable()
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=2)
    dev = torch.device("cuda", 0)
    x = torch.arange(8, dtype=torch.float32, device=dev) + rank
    try:
        if name == "all_reduce":
            dist.all_reduce(x.clone())
        elif name == "all_reduce_avg":
            dist.all_reduce(x.clone(), op=dist.ReduceOp.AVG)
        elif name == "all_gather_into_tensor":
            dist.all_gather_into_tensor(torch.empty(16, device=dev), x)
        elif name == "reduce_scatter_tensor":
            dist.reduce_scatter_tensor(torch.empty(4, device=dev), x)
        elif name == "all_to_all_single":
            dist.all_to_all_single(torch.empty(8, device=dev), x)
        elif name == "functional_all_gather":
            out = torch.ops._c10d_functional.all_gather_into_tensor(
                x, 2, dist.group.WORLD.group_name)
            torch.ops._c10d_functional.wait_tensor(out)
        else:
            from torch.distributed.device_mesh import DeviceMesh
            from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

            mesh = DeviceMesh("cuda", torch.arange(2).reshape(1, 2),
                              mesh_dim_names=("data", "model"))
            src, dst = {
                "dtensor_partial_to_replicate": (Partial(), Replicate()),
                "dtensor_partial_to_shard": (Partial(), Shard(0)),
                "dtensor_shard_to_replicate": (Shard(0), Replicate()),
                "dtensor_shard0_to_shard1": (Shard(0), Shard(1)),
            }[name]
            d = DTensor.from_local(torch.ones(4, 4, device=dev) * (rank + 1), mesh,
                                   (Replicate(), src), run_check=False)
            d.redistribute(mesh, (Replicate(), dst)).to_local()
        torch.cuda.synchronize()
        result = "ok"
    except Exception as e:  # a collective the backend refuses: report it
        result = f"raised {e!r}"[:300]
    if rank == 0:
        print(f"{name}: {result}", flush=True)
    dist.destroy_process_group()


def main():
    import torch

    print(f"torch {torch.__version__} (CUDA {torch.version.cuda}) on "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    for name in CASES:
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            port = sock.getsockname()[1]
        procs = [subprocess.Popen([sys.executable, __file__, name, str(r), str(port)])
                 for r in range(2)]
        try:
            codes = [p.wait(timeout=240) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        print(f"{name}: ranks' exit codes {codes}", flush=True)


if __name__ == "__main__":
    if len(sys.argv) > 1:
        _case(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]))
    else:
        main()
