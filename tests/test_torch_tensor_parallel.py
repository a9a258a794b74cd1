"""Tensor, expert and sequence parallelism of the port's LM on gloo (CPU).

One gloo world of 4 ranks, spawned once as processes running this file
(``python tests/test_torch_tensor_parallel.py WORLD RANK PORT OUT``) on
127.0.0.1, one thread each, runs every check of :func:`_rank_checks` on a
``("data", "model")`` mesh of (2, 2), for the smoke configs of qwen3-1.7b
(dense, GQA 4/2 heads), zamba2-7b (hybrid: shared attention and Mamba2, 8
SSM heads) and olmoe-1b-7b (moe, 8 experts).  The weights are the JAX
reference's ``init_params(PRNGKey(0))``, carried across with
``lm_params_from_jax`` (the parent hands them over as numpy arrays, so the
ranks import no JAX); the inputs come from a numpy seed.  Everything runs
in float32: the LM casts its norms, router and scan to float32 whatever
the weights are, as the reference does.

Parameters are DTensors placed by ``launch.mesh.place`` (the reference's
rules), the activations laid out by ``ShardingPolicy(("data",),
"model")``; the LM kernels' CPU twins run on each rank's shards
(``use_flash="interpret"``), and each rank records the head and expert
counts the kernels' entries saw.  The parent holds the ranks' results:

* ``loss_fn`` and its gradients against the port's single process, within
  the reorder bound below, and against the JAX reference's single-device
  ``loss_fn`` at the LM tests' parity limits;
* the gloo-on-CUDA gather route (an all-reduce of zero-padded shards,
  forced here on the CPU, with DTensor's functional all-gather refused)
  bitwise the all-gather route, and sequence parallelism (the sequence on
  ``"data"``) on that route within the reorder bound;
* ``make_accum_train_step`` with a data-axis ``grad_constraint`` (ZeRO-2:
  the buffers sharded on ``"data"``) against the step without it;
* ``serve_step`` with ``cache_constraints`` (caches placed by
  ``cache_pspecs``): the greedy tokens of the single process, also under
  FSDP, where each rank's decode attends over its batch shard of the cache;
* the loss vocab-parallel: each rank's log-softmax takes its half of the
  vocabulary;
* a checkpoint saved on the (2, 2) mesh restored onto (1, 4) and (4, 1),
  bitwise (the counterpart of the reference's
  ``tests/test_launch_distributed.py::test_elastic_checkpoint_reshard``).

A world of one, in this process: DTensor parameters on a (1, 1) mesh take
two AdamW steps bitwise the steps without a mesh.  The ranks are joined
with one timeout; a rank still alive fails the tests.
"""
import os
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np
import pytest
import torch

HERE = os.path.abspath(__file__)
SRC = os.path.join(os.path.dirname(os.path.dirname(HERE)), "src")
if SRC not in sys.path:
    sys.path.insert(0, SRC)

ARCHS = ("qwen3-1.7b", "zamba2-7b", "olmoe-1b-7b")
WORLD, SHAPE = 4, (2, 2)
B, S, DECODE = 4, 8, 4
JOIN_S = 150
# The LM tests' parity limits against the reference (tests/test_torch_lm_train.py).
LOSS_ATOL = 2e-5
GRAD_TOL = dict(rtol=2e-4, atol=1e-6)
# Sharded against single-process: the row-parallel products' partial sums,
# the vocab-parallel lookup, the cross-rank norm means and the data axis's
# gradient sums add float32 terms in another order.  Each leaf within 64
# float32 ulps of its largest element (measured: under 8).
REORDER = 64 * 2.0 ** -23
RESHARD = ((1, 4), (4, 1))
# More layouts, their loss and gradients against the single process, with
# the batch's rows on "data" as the production step places them: the
# parameters also sharded on "data" (FSDP: the lookup gathers the embedding's
# width, the experts their weights'), and heads the model axis cannot split
# evenly (3 query heads and 1 KV head on 2: held replicated there), and
# query heads it splits beside a KV head it cannot (4 and 1 on 2: each rank
# takes 2 query heads and the KV head of their group).
VARIANTS = {"qwen3-1.7b-fsdp": ("qwen3-1.7b", True, {}),
            "olmoe-1b-7b-fsdp": ("olmoe-1b-7b", True, {}),
            "qwen3-1.7b-3-heads": ("qwen3-1.7b", False, dict(n_heads=3, n_kv_heads=1)),
            "qwen3-1.7b-kv1": ("qwen3-1.7b", False, dict(n_heads=4, n_kv_heads=1))}
# (query heads, KV heads) the attention kernel sees on each rank, by variant
HEADS_SEEN = {"qwen3-1.7b-3-heads": (3, 1), "qwen3-1.7b-kv1": (2, 1)}
# The FSDP decode's widths: qwen3-1.7b's smoke d_model, and one at which
# DTensor resolves x @ wq as partial sums over "data" (at 64 and 256 it
# gathers wq instead and q keeps its batch shard; at 512 and 1024 it does
# not), with the port's own init_params(0) weights.
FSDP_DECODE = {"d64": None, "d512": 512}


def _free_port():
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _cfg(arch):
    from repro_torch.configs import get_arch

    return get_arch(arch).smoke()


def _variant_cfg(case):
    import dataclasses

    arch, _, over = VARIANTS[case]
    return dataclasses.replace(_cfg(arch), **over)


def _batch(cfg, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, size=(B, S + 1), dtype=np.int64)
    return {"tokens": torch.from_numpy(toks[:, :-1].copy()),
            "labels": torch.from_numpy(toks[:, 1:].copy()),
            "loss_mask": torch.from_numpy((rng.random((B, S)) < 0.7).astype(np.float32))}


def _params(weights, arch):
    from repro_torch.models import lm_params_from_jax

    return lm_params_from_jax(weights[arch], device="cpu")


OPTS = dict(use_flash="interpret")


def _loss_and_grads(cfg, params, opts, mesh=None, batch_on_data=False):
    """``loss_fn`` and its gradients, full; with ``batch_on_data``, the
    batch's rows laid out on ``"data"`` (``batch_pspecs``) as the
    production step lays them out."""
    from repro_torch.launch.mesh import Sharding, batch_pspecs, place
    from repro_torch.models import loss_fn
    from repro_torch.models.transformer import settle
    from repro_torch.spmd import full, placements_for

    leaves = list(params.parameters())
    batch = _batch(cfg)
    if batch_on_data:
        specs = batch_pspecs(mesh, batch)
        batch = {k: place(v, Sharding(mesh, placements_for(mesh, specs[k])))
                 for k, v in batch.items()}
    if mesh is None:
        loss = loss_fn(cfg, params, batch, opts)
    else:
        with mesh:
            loss = loss_fn(cfg, params, batch, opts)
    grads = torch.autograd.grad(loss, leaves)
    names = [n for n, _ in params.named_parameters()]
    return full(loss.detach()), {n: full(settle(g, p)) for n, g, p in zip(names, grads, leaves)}


def _decode(cfg, params, cache, opts, mesh=None):
    """Greedy tokens and logits of ``DECODE`` ticks from two prompts' first
    tokens (the batch rows split over ``"data"``)."""
    from contextlib import nullcontext

    from repro_torch.models import serve_step
    from repro_torch.spmd import full

    tok = torch.tensor([3, 7])
    toks, logits = [], []
    with torch.no_grad(), (mesh if mesh is not None else nullcontext()):
        for pos in range(DECODE):
            out, cache = serve_step(cfg, params, cache, tok, pos, opts)
            out = full(out)
            tok = out.argmax(-1)
            toks.append(tok)
            logits.append(out)
    return torch.stack(toks), torch.stack(logits)


def _accum(cfg, params, mesh, zero2: bool):
    """One AdamW step of ``make_accum_train_step`` over two microbatches,
    with a ZeRO-2 ``grad_constraint`` (the buffers sharded on ``"data"``)
    or none; the parameters after it (full) and which mesh dims shard each
    buffer."""
    from repro_torch.launch.mesh import gather_full, opt_state_shardings, place
    from repro_torch.models import ModelOptions, ShardingPolicy
    from repro_torch.optim import adamw
    from repro_torch.train import make_accum_train_step

    opt = adamw(1e-2)
    state = opt.init(list(params.parameters()))
    seen = []
    constraint = None
    if zero2:
        mu = opt_state_shardings(mesh, params, zero1=True).mu

        def constraint(bufs):
            out = place(bufs, mu)
            seen.append([tuple(p.is_shard() for p in b.placements) for b in out])
            return out
    opts = ModelOptions(**OPTS, shard=ShardingPolicy(("data",), "model"))
    step = make_accum_train_step(cfg, opt, opts, microbatches=2, grad_constraint=constraint)
    batch = {k: v.reshape(2, B // 2, *v.shape[1:]) for k, v in _batch(cfg, 1).items()}
    with mesh:
        _, _, metrics = step(params, state, batch)
    gather_full(params)
    return {"params": {n: p.detach() for n, p in params.named_parameters()},
            "loss": metrics["loss"], "layouts": seen[-1] if seen else None}


def _reshard(cfg, weights, arch, mesh):
    """Save (parameters, AdamW state after a step) on ``mesh``, restore onto
    each mesh of ``RESHARD``: the restored leaves, full, bitwise the saved
    ones, and each leaf on the new mesh."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import (gather_full, opt_state_shardings, param_shardings,
                                         place)
    from repro_torch.models import ModelOptions, ShardingPolicy, make_train_step
    from repro_torch.optim import adamw
    from repro_torch.spmd import full
    from repro_torch.train.checkpoint import restore_checkpoint, save_checkpoint
    from torch.distributed.device_mesh import DeviceMesh

    params = _params(weights, arch)
    place(params, param_shardings(mesh, params))
    opt = adamw(1e-2)
    state = opt.init(list(params.parameters()))
    opts = ModelOptions(**OPTS, shard=ShardingPolicy(("data",), "model"))
    with mesh:
        _, state, _ = make_train_step(cfg, opt, opts)(params, state, _batch(cfg, 2))
    saved = [full(t.detach()) for t in list(params.parameters()) + state.mu + state.nu]
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        d = [tmp]
        dist.broadcast_object_list(d, src=0)  # rank 0's directory for every rank
        save_checkpoint(d[0], 1, (params, state))
        for shape in RESHARD:
            new = DeviceMesh("cpu", torch.arange(WORLD).reshape(shape),
                             mesh_dim_names=("data", "model"))
            p2, s2 = restore_checkpoint(d[0], 1, (params, state), shardings=(
                param_shardings(new, params), opt_state_shardings(new, params)))
            leaves = list(p2.parameters()) + s2.mu + s2.nu
            on_new = all(t.device_mesh == new for t in leaves)
            got = [full(t.detach()) for t in leaves]
            out[shape] = (on_new, all(torch.equal(a, b) for a, b in zip(got, saved)),
                          sum(t.to_local().numel() for t in leaves[:len(saved) // 3]))
            params, state = p2, s2
        dist.barrier()  # rank 0 removes the directory last
    gather_full(params)
    return out


class _no_functional_all_gather:
    """DTensor's functional all-gathers raise inside: the route gloo takes
    on CUDA tensors, where they kill the process, must not reach one."""

    NAMES = ("all_gather_tensor", "all_gather_single", "all_gather_tensor_autograd",
             "all_gather_single_autograd")

    def __enter__(self):
        import torch.distributed._functional_collectives as funcol

        def refuse(*args, **kwargs):
            raise AssertionError("a functional all-gather on the all-reduce route")

        self.saved = {n: getattr(funcol, n) for n in self.NAMES if hasattr(funcol, n)}
        for n in self.saved:
            setattr(funcol, n, refuse)

    def __exit__(self, *exc):
        import torch.distributed._functional_collectives as funcol

        for n, fn in self.saved.items():
            setattr(funcol, n, fn)
        return False


def _rank_checks(weights, rank):
    """Every check of one rank, for each arch."""
    import repro_torch.spmd as spmd
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.launch.mesh import cache_shardings, param_shardings, place
    from repro_torch.models import ModelOptions, ShardingPolicy, init_cache, init_params
    from repro_torch.models import attention, moe, transformer
    from torch.distributed.device_mesh import DeviceMesh

    seen = {"attention": set(), "ssd": set(), "experts": set(), "loss_vocab": set(),
            "decode_cache": set()}
    attention_ref, ssd_ref, experts = fa_ops.attention_ref, ssd_ops.ssd_chunked_ref, moe._experts
    nll, decode = transformer._sharded_nll_sums, attention._decode

    def record_nll(logits, *args):
        seen["loss_vocab"].add(logits.shape[-1])
        return nll(logits, *args)

    def record_decode(q, k_cache, *args):
        seen["decode_cache"].add(tuple(k_cache.shape[:2]))
        return decode(q, k_cache, *args)

    def record_attention(q, k, v, **kw):
        seen["attention"].add((q.shape[0], q.shape[1], k.shape[1]))
        return attention_ref(q, k, v, **kw)

    def record_ssd(x, dt, A, B_, C, **kw):
        seen["ssd"].add((x.shape[0], x.shape[2], B_.shape[2]))
        return ssd_ref(x, dt, A, B_, C, **kw)

    def record_experts(p, xe):
        seen["experts"].add((p["wg"].shape[0], xe.shape[1]))
        return experts(p, xe)

    fa_ops.attention_ref, ssd_ops.ssd_chunked_ref = record_attention, record_ssd
    moe._experts = record_experts
    transformer._sharded_nll_sums, attention._decode = record_nll, record_decode
    mesh = DeviceMesh("cpu", torch.arange(WORLD).reshape(SHAPE),
                      mesh_dim_names=("data", "model"))
    opts = ModelOptions(**OPTS, shard=ShardingPolicy(("data",), "model"))
    got = {}
    for arch in ARCHS:
        cfg = _cfg(arch)
        for key in seen:
            seen[key] = set()
        params = _params(weights, arch)
        place(params, param_shardings(mesh, params))
        res = {"loss_grads": _loss_and_grads(cfg, params, opts, mesh),
               "seen": {k: sorted(v) for k, v in seen.items() if k != "decode_cache"}}
        gathers = spmd._gathers_by_all_reduce
        spmd._gathers_by_all_reduce = lambda mesh: True
        try:
            with _no_functional_all_gather():
                res["by_all_reduce"] = _loss_and_grads(cfg, params, opts, mesh)
                res["sequence"] = _loss_and_grads(cfg, params, ModelOptions(
                    **OPTS, shard=ShardingPolicy(None, "model", ("data",))), mesh)
        finally:
            spmd._gathers_by_all_reduce = gathers
        cache = init_cache(cfg, 2, DECODE, device="cpu")
        shardings, constraints = cache_shardings(mesh, cache, batch=2)
        cache = place(cache, shardings)
        res["decode"] = _decode(cfg, params, cache, ModelOptions(
            shard=opts.shard, cache_constraints=constraints), mesh)
        res["accum"] = {z: _accum(cfg, _placed(weights, arch, mesh), mesh, z)
                        for z in (False, True)}
        res["reshard"] = _reshard(cfg, weights, arch, mesh)
        got[arch] = res
    for case, (_, fsdp, _) in VARIANTS.items():
        seen["attention"] = set()
        cfg = _variant_cfg(case)
        params = _params(weights, case)
        place(params, param_shardings(mesh, params, fsdp=fsdp))
        got[case] = {"loss_grads": _loss_and_grads(cfg, params, opts, mesh, batch_on_data=True),
                     "attention": sorted(seen["attention"]),
                     "on_data": sum(p.placements[0].is_shard() for p in params.parameters())}
    for label, width in FSDP_DECODE.items():  # decode with the batch on "data"
        cfg = _fsdp_decode_cfg(width)
        params = _params(weights, "qwen3-1.7b") if width is None else init_params(cfg, 0,
                                                                                   device="cpu")
        place(params, param_shardings(mesh, params, fsdp=True))
        seen["decode_cache"] = set()
        cache = init_cache(cfg, 2, DECODE, device="cpu")
        shardings, constraints = cache_shardings(mesh, cache, batch=2)
        got[f"fsdp-decode-{label}"] = {
            "decode": _decode(cfg, params, place(cache, shardings), ModelOptions(
                shard=opts.shard, cache_constraints=constraints), mesh),
            "decode_cache": sorted(seen["decode_cache"])}
    return got


def _fsdp_decode_cfg(width):
    import dataclasses

    cfg = _cfg("qwen3-1.7b")
    return cfg if width is None else dataclasses.replace(cfg, d_model=width)


def _placed(weights, arch, mesh):
    from repro_torch.launch.mesh import param_shardings, place

    params = _params(weights, arch)
    return place(params, param_shardings(mesh, params))


def _worker(world: int, rank: int, port: int, out: str) -> None:
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=world)
    try:
        weights = torch.load(f"{out}.weights", weights_only=False)
        torch.save(_rank_checks(weights, rank), f"{out}.{rank}")
    finally:
        dist.destroy_process_group()


# -- the parent ------------------------------------------------------------------

@pytest.fixture(scope="module")
def weights():
    """The reference's ``init_params(PRNGKey(0))`` per smoke arch and per
    variant of :data:`VARIANTS`, as numpy."""
    import dataclasses

    import jax

    from repro.configs import get_arch as jget_arch
    from repro.models import init_params as jinit_params

    init = jax.jit(jinit_params, static_argnums=0)
    out = {arch: jax.tree_util.tree_map(np.asarray, init(
        jget_arch(arch).smoke(), jax.random.PRNGKey(0))) for arch in ARCHS}
    for case, (arch, _, over) in VARIANTS.items():
        out[case] = out[arch] if not over else jax.tree_util.tree_map(np.asarray, init(
            dataclasses.replace(jget_arch(arch).smoke(), **over), jax.random.PRNGKey(0)))
    return out


def _single(weights):
    """The single-process port: loss, gradients, decode and accumulating
    steps, with the same twins as the ranks."""
    from repro_torch.models import ModelOptions, init_cache, init_params

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        out = {}
        for arch in ARCHS:
            cfg = _cfg(arch)
            out[arch] = {
                "loss_grads": _loss_and_grads(cfg, _params(weights, arch),
                                              ModelOptions(**OPTS)),
                "decode": _decode(cfg, _params(weights, arch),
                                  init_cache(cfg, 2, DECODE, device="cpu"), ModelOptions())}
        for case in VARIANTS:
            out[case] = {"loss_grads": _loss_and_grads(_variant_cfg(case), _params(weights, case),
                                                       ModelOptions(**OPTS))}
        cfg = _fsdp_decode_cfg(FSDP_DECODE["d512"])
        out["fsdp-decode-d512"] = {"decode": _decode(cfg, init_params(cfg, 0, device="cpu"),
                                                     init_cache(cfg, 2, DECODE, device="cpu"),
                                                     ModelOptions())}
        out["fsdp-decode-d64"] = out["qwen3-1.7b"]  # the same weights
        return out
    finally:
        torch.set_num_threads(threads)


def _reference(weights):
    """The JAX reference's single-device loss and gradients."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_arch as jget_arch
    from repro.models import loss_fn as jloss_fn

    out = {}
    for arch in ARCHS:
        jcfg = jget_arch(arch).smoke()
        batch = {k: jnp.asarray(v.numpy()) for k, v in _batch(_cfg(arch)).items()}
        loss, grads = jax.jit(jax.value_and_grad(lambda p, b: jloss_fn(jcfg, p, b)))(
            jax.tree_util.tree_map(jnp.asarray, weights[arch]), batch)
        out[arch] = (float(loss), jax.tree_util.tree_map(np.asarray, grads))
    return out


@pytest.fixture(scope="module")
def world(weights):
    """Every rank's results (the 4 ranks spawned once) and, computed here
    while they run: the single-process port and the JAX reference."""
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "tp")
        torch.save(weights, f"{out}.weights")
        env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
        port = _free_port()
        procs = [subprocess.Popen([sys.executable, HERE, str(WORLD), str(r), str(port), out],
                                  env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
                 for r in range(WORLD)]
        deadline = time.monotonic() + JOIN_S
        here = {"single": _single(weights), "reference": _reference(weights)}
        logs, alive = [], []
        for r, p in enumerate(procs):
            try:
                logs.append(p.communicate(timeout=max(deadline - time.monotonic(), 1))[0]
                            .decode()[-3000:])
            except subprocess.TimeoutExpired:
                alive.append(r)
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        assert not alive, f"ranks {alive} still alive after {JOIN_S} s"
        assert all(p.returncode == 0 for p in procs), "\n".join(logs)
        here["ranks"] = [torch.load(f"{out}.{r}", weights_only=False) for r in range(WORLD)]
        return here


def _named(jtree):
    """(port parameter name, numpy array) for every reference leaf, the
    stacked layer leaves split per layer."""
    import jax

    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(jtree)[0]:
        keys = [p.key for p in path]
        if keys[0] == "layers":
            for i in range(leaf.shape[0]):
                out[".".join(["layers", str(i)] + keys[1:])] = leaf[i]
        else:
            out[".".join(keys)] = leaf
    return out


def _reorder_close(got, want):
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    assert err <= REORDER * max(scale, 1.0), (err, scale)


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_loss_and_gradients_match_the_single_process(world, arch):
    loss, grads = world["ranks"][0][arch]["loss_grads"]
    loss0, grads0 = world["single"][arch]["loss_grads"]
    _reorder_close(loss, loss0)
    assert sorted(grads) == sorted(grads0)
    for name, g in grads.items():
        _reorder_close(g, grads0[name])


@pytest.mark.parametrize("case", list(VARIANTS))
def test_fsdp_and_uneven_heads_match_the_single_process(world, case):
    """FSDP parameters (on "data" as well as "model"), and heads the model
    axis cannot split: loss and gradients within the reorder bound."""
    _, fsdp, over = VARIANTS[case]
    res = world["ranks"][0][case]
    assert (res["on_data"] > 0) == fsdp
    if over:  # the heads the kernel saw on each rank
        assert res["attention"] == [(B // 2, *HEADS_SEEN[case])]
    loss, grads = res["loss_grads"]
    loss0, grads0 = world["single"][case]["loss_grads"]
    _reorder_close(loss, loss0)
    assert sorted(grads) == sorted(grads0)
    for name, g in grads.items():
        _reorder_close(g, grads0[name])


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_takes_each_rank_vocabulary_shard(world, arch):
    """The vocab-parallel loss: each rank's log-softmax saw the logits of its
    half of the (padded) vocabulary, never the whole rows; its loss and
    gradients are held to the single process and the reference above."""
    width = _cfg(arch).padded_vocab // SHAPE[1]
    for rank in world["ranks"]:
        assert rank[arch]["seen"]["loss_vocab"] == [width]


def test_query_heads_shard_over_a_gathered_kv_group(world):
    """4 query heads and 1 KV head on a model axis of 2: each rank's kernel
    ran its 2 query heads against the one KV head (taken whole), and loss
    and gradients (the KV gradients summed over the two ranks) match the
    single process within the reorder bound."""
    case = "qwen3-1.7b-kv1"
    for rank in world["ranks"]:
        assert rank[case]["attention"] == [(B // 2, 2, 1)]
    loss, grads = world["ranks"][0][case]["loss_grads"]
    loss0, grads0 = world["single"][case]["loss_grads"]
    _reorder_close(loss, loss0)
    assert sorted(grads) == sorted(grads0)
    for name, g in grads.items():
        _reorder_close(g, grads0[name])


@pytest.mark.parametrize("width", list(FSDP_DECODE))
def test_fsdp_decode_attends_over_each_rank_batch_shard(world, width):
    """qwen3-1.7b's FSDP parameters (on "data" as well as "model"): the
    decode lays q, k and v out on the cache's batch shard (at d512 ``x @
    wq`` comes back as partial sums over "data"), so each rank's attention
    read its 1 of 2 batch rows of the cache (and 1 of 2 KV heads), and the
    greedy tokens are the single process's."""
    case = f"fsdp-decode-{width}"
    cfg = _cfg("qwen3-1.7b")
    for rank in world["ranks"]:
        assert rank[case]["decode_cache"] == [(1, cfg.n_kv_heads // SHAPE[1])]
    toks, logits = world["ranks"][0][case]["decode"]
    toks0, logits0 = world["single"][case]["decode"]
    assert torch.equal(toks, toks0)
    _reorder_close(logits, logits0)


@pytest.mark.parametrize("arch", ARCHS)
def test_sequence_parallel_loss_and_gradients_match_the_single_process(world, arch):
    """``ShardingPolicy(None, "model", ("data",))``: the sequence on
    ``"data"`` in place of the batch (the kernels gather it), on the
    gloo-on-CUDA route."""
    loss, grads = world["ranks"][0][arch]["sequence"]
    loss0, grads0 = world["single"][arch]["loss_grads"]
    _reorder_close(loss, loss0)
    for name, g in grads.items():
        _reorder_close(g, grads0[name])


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_loss_and_gradients_match_the_reference(world, arch):
    loss, grads = world["ranks"][0][arch]["loss_grads"]
    jloss, jgrads = world["reference"][arch]
    np.testing.assert_allclose(float(loss), jloss, rtol=0, atol=LOSS_ATOL)
    want = _named(jgrads)
    assert sorted(want) == sorted(grads)
    for name, arr in want.items():
        np.testing.assert_allclose(grads[name].numpy(), arr, **GRAD_TOL, err_msg=name)


@pytest.mark.parametrize("arch", ARCHS)
def test_every_rank_holds_the_same_results(world, arch):
    first = world["ranks"][0][arch]
    for other in world["ranks"][1:]:
        mine = other[arch]
        assert torch.equal(mine["loss_grads"][0], first["loss_grads"][0])
        assert all(torch.equal(mine["loss_grads"][1][n], g)
                   for n, g in first["loss_grads"][1].items())
        assert torch.equal(mine["decode"][0], first["decode"][0])


@pytest.mark.parametrize("arch", ARCHS)
def test_kernels_ran_on_local_shards(world, arch):
    """The kernels' entries saw each rank's shard: half the batch rows, and
    half the query and KV heads (4/2 -> 2/1), half the SSM heads (8 -> 4)
    with the whole state, half the experts (8 -> 4)."""
    cfg = _cfg(arch)
    for rank in world["ranks"]:
        seen = rank[arch]["seen"]
        assert seen["attention"] == [(B // 2, cfg.n_heads // 2, cfg.n_kv_heads // 2)]
        if cfg.family == "hybrid":
            assert seen["ssd"] == [(B // 2, cfg.ssm_heads // 2, cfg.ssm_state)]
        else:
            assert seen["ssd"] == []
        if cfg.family == "moe":
            assert {e for e, _ in seen["experts"]} == {cfg.n_experts // 2}
        else:
            assert seen["experts"] == []


@pytest.mark.parametrize("arch", ARCHS)
def test_gather_by_all_reduce_is_bitwise_the_all_gather(world, arch):
    """The route gloo takes on CUDA tensors (zero-padded shards summed)
    gives the all-gather's values exactly."""
    res = world["ranks"][0][arch]
    (l1, g1), (l0, g0) = res["by_all_reduce"], res["loss_grads"]
    assert torch.equal(l1, l0)
    assert all(torch.equal(g1[n], g) for n, g in g0.items())


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_decode_gives_the_single_process_tokens(world, arch):
    toks, logits = world["ranks"][0][arch]["decode"]
    toks0, logits0 = world["single"][arch]["decode"]
    assert torch.equal(toks, toks0)
    _reorder_close(logits, logits0)


@pytest.mark.parametrize("arch", ARCHS)
def test_zero2_grad_constraint_shards_the_buffer(world, arch):
    """A data-axis ``grad_constraint``: every buffer that ``"data"`` can
    split lies sharded on it, and the step equals the step without the
    constraint within the reorder bound (the global norm sums other
    partials)."""
    acc = world["ranks"][0][arch]["accum"]
    layouts = acc[True]["layouts"]
    assert any(on_data for on_data, _ in layouts)
    assert acc[False]["layouts"] is None
    _reorder_close(acc[True]["loss"], acc[False]["loss"])
    for name, p in acc[True]["params"].items():
        _reorder_close(p, acc[False]["params"][name])


@pytest.mark.parametrize("shape", RESHARD, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("arch", ARCHS)
def test_checkpoint_restores_onto_another_mesh_bitwise(world, arch, shape):
    sizes = []
    for rank in world["ranks"]:
        on_new, equal, local = rank[arch]["reshard"][shape]
        assert on_new and equal
        sizes.append(local)
    total = sum(p.numel() for p in world["single"][arch]["loss_grads"][1].values())
    if shape[1] > 1:  # the model axis shards leaves on the new mesh
        assert sum(sizes) < WORLD * total
    else:
        assert sizes == [total] * WORLD


@pytest.fixture
def world_of_one():
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{_free_port()}", rank=0,
                            world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("arch", ARCHS)
def test_mesh_of_one_is_bitwise_the_no_mesh_steps(weights, arch, world_of_one):
    """Two AdamW steps with every parameter a DTensor on a (1, 1) mesh under
    ``ShardingPolicy(("data",), "model")``: the losses, gradient norms and
    parameters bitwise the same steps without a mesh."""
    from repro_torch.launch.mesh import gather_full, param_shardings, place
    from repro_torch.models import ModelOptions, ShardingPolicy, make_train_step
    from repro_torch.optim import adamw
    from torch.distributed.device_mesh import DeviceMesh

    cfg = _cfg(arch)
    runs = []
    for mesh in (None, DeviceMesh("cpu", torch.zeros(1, 1, dtype=torch.int64),
                                  mesh_dim_names=("data", "model"))):
        params = _params(weights, arch)
        opts = ModelOptions(**OPTS, remat=True)
        if mesh is not None:
            place(params, param_shardings(mesh, params))
            opts = ModelOptions(**OPTS, remat=True, shard=ShardingPolicy(("data",), "model"))
        opt = adamw(1e-2)
        state = opt.init(list(params.parameters()))
        step = make_train_step(cfg, opt, opts)
        metrics = []
        for i in range(2):
            if mesh is None:
                _, state, m = step(params, state, _batch(cfg, i))
            else:
                with mesh:
                    _, state, m = step(params, state, _batch(cfg, i))
            metrics.append((m["loss"], m["grad_norm"]))
        gather_full(params)
        runs.append((metrics, [p.detach() for p in params.parameters()]))
    (m0, p0), (m1, p1) = runs
    assert all(torch.equal(a, b) for x, y in zip(m0, m1) for a, b in zip(x, y))
    assert all(torch.equal(a, b) for a, b in zip(p0, p1))


def test_launcher_mesh_gives_the_single_process_losses(capsys):
    """``python -m repro_torch.launch.train --mesh 1x2``, two ranks as
    processes: each prints the losses the launcher prints without a mesh
    (to its 4 printed decimals)."""
    from repro_torch.launch.train import main

    argv = ["--arch", "qwen3-1.7b", "--steps", "2", "--device", "cpu"]
    main(argv)
    want = [line for line in capsys.readouterr().out.splitlines() if line.startswith("step")]
    init = f"tcp://127.0.0.1:{_free_port()}"
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-m", "repro_torch.launch.train", *argv,
                               "--mesh", "1x2", "--rank", str(r), "--init-method", init],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(2)]
    try:
        outs = [p.communicate(timeout=JOIN_S) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert all(p.returncode == 0 for p in procs), [err[-2000:] for _, err in outs]
    assert len(want) == 2
    for out, _ in outs:
        assert [line for line in out.splitlines() if line.startswith("step")] == want


if __name__ == "__main__":
    _worker(*(int(a) for a in sys.argv[1:4]), sys.argv[4])
