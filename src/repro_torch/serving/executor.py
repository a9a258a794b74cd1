"""Device-side serving executor: one callable per signature and stack depth.

Port of ``repro.serving.executor``.  The executor knows nothing about
requests or queues: its unit of work is a **tick stack** — a
``(n_ticks, slots, 2)`` tensor of per-path keys on the device, every tick
sharing one request signature or one padded bucket — which it runs through
:func:`repro_torch.core.sdeint_ticks`.  ``n_dispatches`` / ``n_ticks`` count
host round trips and the ticks they served.  Adaptive requests dispatch as
one forward-only controller pass (``bounded=False``), as in the reference.

Where the reference jits one executable per ``(signature-or-BucketKey,
n_ticks)``, the port captures **one tick** into a CUDA graph on the card:
one graph per exact signature, and one per ``(BucketKey, live steps)``,
since a bucket's ticks differ in live steps (the reference skips padding
steps with a batch-uniform ``lax.cond``; a graph per pattern of live counts
would multiply with the depth, and masked padding steps would compute work
the reference skips).  A dispatch of ``T`` ticks makes ``T`` replays, each
running exactly the ops of the eager tick, so its result is bitwise the
eager one's.  A dispatch enqueues device work and returns device tensors
without synchronising with the host (bucket live-step counts are host
integers from the plan), so the engine can plan the next stack while the
device integrates this one.

What XLA compilation is to the reference — the stall a first dispatch pays,
which ``warmup`` moves ahead of traffic and the persistent compilation cache
carries across processes — is here the ``nvcc`` build of the kernel
libraries a ``use_kernels`` spec launches and the capture of the tick's
graph: :meth:`TickExecutor.warmup` does both, and
:func:`enable_persistent_compile_cache` keeps the libraries in a directory
a later process loads them from.  Graphs belong to the process: a warm
second process loads its libraries and captures its graphs again.
"""
from __future__ import annotations

import contextlib
import threading
import time
from typing import Any, Callable, Dict, Optional, Sequence, Tuple, Union

import torch

from ..core.pytree import tree_flatten, tree_unflatten
from ..core.registry import get_solver, parse_solver_spec
from ..core.sdeint import sdeint_ticks, tick_solve
from ..core.solvers import ButcherSolver, LowStorageSolver, MCFSolver, Milstein, ReversibleHeun
from ..device import resolve_device
from ..kernels import _build
from ..kernels.sde_step import sde_step as _sk
from ..kernels.williamson2n.williamson2n import KERNEL as _WILLIAMSON2N
from ..launch.mesh import graph_capturable
from .bucketing import BucketKey

__all__ = ["TickExecutor", "enable_persistent_compile_cache", "spec_kernels"]

# One capture at a time in the process (a GraphLaunches record is
# process-wide): executors capturing from several threads take turns.
_CAPTURE_LOCK = threading.Lock()


def enable_persistent_compile_cache(path: str) -> None:
    """Keep the port's compiled kernel libraries in ``path``.

    The counterpart of the reference's jax persistent compilation cache:
    every kernel library not yet loaded in this process is built into (and
    loaded from) ``path``, named by a hash of its sources and flags, so a
    later process pointed at the same directory loads it and runs no
    ``nvcc`` — a restarted engine warm-starts."""
    _build.set_library_dir(path)


# Kernels by (effective noise) for the increment and the fused 2N stage.
_INCREMENT = {"diagonal": _sk.INCREMENT_DIAG, "general": _sk.INCREMENT_GENERAL,
              "prediffused": _sk.INCREMENT_PRE}
_STAGE = {"diagonal": _sk.WS_STAGE_DIAG, "general": _sk.WS_STAGE_GENERAL,
          "prediffused": _sk.WS_STAGE_PRE}


def spec_kernels(spec: str, noise: str) -> Tuple[_build.CudaKernel, ...]:
    """The CUDA kernels a forward solve with ``spec`` launches on a term of
    declared ``noise`` (``()`` unless the spec sets ``use_kernels``).

    Mirrors the solvers' routing (``core/solvers.py``) under the serving
    solve (full adjoint, bulk increments): an additive term takes the
    prediffused route unless the solver reads the diffusion itself
    (Milstein); EES stages fuse diagonal, general and prediffused noise into
    one stage kernel and run the ``williamson2n`` update otherwise; Butcher
    and MCF schemes add one ``axpy_chain`` per stage combination."""
    solver = get_solver(spec)
    if not getattr(solver, "use_kernels", False):
        return ()
    if noise == "additive":
        noise = ("diagonal" if getattr(solver, "needs_diffusion", False)
                 else "prediffused")
    if isinstance(solver, LowStorageSolver):
        return (_STAGE[noise],) if noise in _STAGE else (_WILLIAMSON2N,)
    inc = (_INCREMENT[noise],) if noise in _INCREMENT else ()
    if isinstance(solver, (ButcherSolver, MCFSolver)):
        return inc + (_sk.AXPY_CHAIN,)
    if isinstance(solver, (ReversibleHeun, Milstein)):
        return inc
    raise NotImplementedError(f"no kernel routing known for {type(solver).__name__}")


class _TickGraph:
    """One tick of one key captured into a CUDA graph.

    ``run(keys)`` solves a one-tick stack (``keys`` ``(1, slots, 2)``) and
    returns the result with leading ``(1, slots)`` axes.  The constructor
    runs it once eagerly on the current stream (first-use work: library
    loads, cuBLAS handles), then captures it on ``stream`` on a static key
    buffer into ``pool``
    (:func:`~repro_torch.kernels._build.capture_graph`); :meth:`replay`
    copies a tick's keys into that buffer and replays on the current
    stream.  The graph's outputs live in ``pool`` and are overwritten by the
    next replay of any graph sharing it, so the caller copies them out
    first.  Launches are counted through
    :class:`~repro_torch.kernels._build.GraphLaunches`.  A capture that
    fails raises."""

    def __init__(self, run: Callable, keys: torch.Tensor, pool, stream):
        self.keys = keys.clone()
        self.record = _build.GraphLaunches()
        device = keys.device
        start = time.perf_counter()
        run(self.keys)
        current = torch.cuda.current_stream(device)
        stream.wait_stream(current)
        before = torch.cuda.memory_reserved(device)
        self.graph, out = _build.capture_graph(lambda: run(self.keys), self.record, stream,
                                               pool)
        current.wait_stream(stream)
        self.pool_bytes = torch.cuda.memory_reserved(device) - before
        self.leaves, self.treedef = tree_flatten(out)
        self.capture_seconds = time.perf_counter() - start

    def replay(self, keys: torch.Tensor):
        """The tick of ``keys`` (``(1, slots, 2)``): the graph's output
        leaves, valid until the next replay on ``pool``."""
        self.keys.copy_(keys)
        self.graph.replay()
        self.record.replay()
        return self.leaves


class TickExecutor:
    """Run same-signature tick stacks for one SDE term on one device.

    ``term``/``y0``/``args`` define the process; ``guard`` is the in-loop
    blow-up threshold every solve carries (None: no guard); ``device``
    (default ``"cuda"``) is where the solves run.  ``mesh`` + ``mesh_axis``
    (both or neither) shard each tick's slot axis over that mesh axis
    through ``sdeint_ticks``: each rank solves its block of the slots and
    every rank gets the whole tick back.

    :meth:`dispatch` fixes the two pieces of torch state that are
    thread-local, so that it behaves the same from any thread (the async
    engine runs first dispatches in a worker thread):

    * **grad mode** — every dispatch runs under ``torch.no_grad()``: serving
      records no autograd graph, whether or not the model's parameters
      require gradients, and whatever the calling thread's mode;
    * **the CUDA stream** — the executor keeps the stream current where it
      was built (``stream``) and enters it in every dispatch, so the
      kernels (which launch on the current stream), the torch ops around
      them and the ``landing`` event it records after each dispatch share
      one stream.  A caller on another stream is ordered before and after
      the dispatch by stream waits, never by a host sync.

    **CUDA graphs.**  On a CUDA device every key whose solve is
    ``capturable`` (fixed and padded grids) runs through captured tick
    graphs (see the module docstring): captured by :meth:`warmup` or by
    its first dispatch, which ``has_compiled`` reports, then replayed.
    Two keys stay eager: adaptive solves, whose controller reads the loop
    condition on the host between trials (a ``while_loop`` with no graph
    counterpart short of conditional nodes), and every key of an executor
    on a mesh whose process groups are not all NCCL (gloo stages CUDA
    tensors through the host, which no graph can hold).  A capture or
    replay that fails raises: nothing falls back to eager ticks.  One
    executor's graphs share one memory pool, since its replays run one at
    a time on ``stream``; ``graph_stats()`` reports graphs, capture
    seconds, replays and the pool's size.
    """

    def __init__(self, term, y0, *, args: Any = None, noise_shape=None,
                 dtype: Any = torch.float32, mesh=None,
                 mesh_axis: Optional[str] = None,
                 guard: Optional[float] = None, device=None):
        if (mesh is None) != (mesh_axis is None):
            raise ValueError(
                "sharded dispatch needs mesh and mesh_axis together; got "
                f"mesh={'set' if mesh is not None else 'None'}, "
                f"mesh_axis={mesh_axis!r}"
            )
        self.term = term
        self.y0 = y0
        self.args = args
        self.noise_shape = noise_shape
        self.dtype = dtype
        self.guard = guard
        self.mesh = mesh
        self.mesh_axis = mesh_axis
        self.device = resolve_device(device)
        # None off CUDA: every stream operation below is then skipped.
        self.stream = (torch.cuda.current_stream(self.device)
                       if self.device.type == "cuda" else None)
        # The last event recorded on ``stream`` (by a dispatch, or by a
        # caller after work of its own there): None off CUDA.
        self.landing: Optional[torch.cuda.Event] = None
        self._callables: Dict[Tuple, Callable] = {}
        self.n_dispatches = 0
        self.n_ticks = 0
        # Tick graphs by (key, live steps or None for a signature, slots).
        self.graphed = self.stream is not None and (
            mesh is None or graph_capturable(mesh))
        self._graphs: Dict[Tuple, _TickGraph] = {}
        self._pool = self._capture_stream = None
        self.n_replays = 0

    def _stack_fn(self, key: Union[Tuple, BucketKey], n_ticks: int) -> Callable:
        """The cached dispatch callable for ``(key, n_ticks)``: ``key`` is an
        exact request signature or a :class:`BucketKey`, whose callable takes
        the ticks' live step counts as its second argument.  It carries
        ``capturable``, its tick solve's mark (``core.sdeint.tick_solve``)."""
        cache_key = (key, n_ticks)
        if cache_key not in self._callables:
            common = dict(args=self.args, noise_shape=self.noise_shape,
                          dtype=self.dtype, guard=self.guard,
                          device=self.device)
            mesh = dict(mesh=self.mesh, mesh_axis=self.mesh_axis)
            if isinstance(key, BucketKey):
                solver, t0, n_steps = key.solver, key.t0, key.n_padded
                t1, opts = t0 + n_steps * key.h, {"step_size": key.h}

                def stack(tick_keys, active_steps):
                    return sdeint_ticks(
                        self.term, solver, t0, t1, n_steps, self.y0, tick_keys,
                        active_steps=active_steps, **opts, **common, **mesh)
            else:
                solver, t0, t1, n_steps, save_every, rtol, atol, save_at = key
                opts = {k: v for k, v in (("save_every", save_every), ("rtol", rtol),
                                          ("atol", atol), ("save_at", save_at))
                        if v is not None}
                if parse_solver_spec(solver)[1].get("adaptive", False):
                    # Serving is forward-only: one controller pass, which
                    # stops once every path reaches t1 (bitwise equal to
                    # realize-then-solve).
                    opts["bounded"] = False

                def stack(tick_keys):
                    return sdeint_ticks(
                        self.term, solver, t0, t1, n_steps, self.y0, tick_keys,
                        **opts, **common, **mesh)

            stack.capturable = tick_solve(self.term, solver, t0, t1, n_steps, self.y0,
                                          **opts, **common).capturable
            self._callables[cache_key] = stack
        return self._callables[cache_key]

    def _captures(self, fn: Callable) -> bool:
        return self.graphed and fn.capturable

    def has_compiled(self, key: Union[Tuple, BucketKey], n_ticks: int,
                     active_steps: Optional[Sequence[int]] = None) -> bool:
        """Whether a dispatch of ``(key, n_ticks)`` would find everything
        ready: its cached callable, and where the key captures, the graph of
        each tick it replays — the signature's one graph, or a bucket's
        graph for each live count in ``active_steps`` (none checked when
        ``active_steps`` is None).  False: the async engine runs the
        dispatch in a worker thread, which may build kernel libraries and
        capture graphs."""
        fn = self._callables.get((key, n_ticks))
        if fn is None:
            return False
        if not self._captures(fn):
            return True
        if not isinstance(key, BucketKey):
            active_steps = (None,)
        captured = {g[:2] for g in self._graphs}
        return all((key, n) in captured for n in (active_steps or ()))

    def warmup(self, key: Union[Tuple, BucketKey], n_ticks: int,
               slots: int) -> bool:
        """Prepare ``(key, n_ticks)`` ahead of traffic.

        Builds (or loads, from the persistent cache) every kernel library the
        key's solver spec launches on this term — the build a first dispatch
        would otherwise stall on; plain specs and CPU executors build
        nothing — and stores the cached callable.  Where the key captures,
        it then captures the graph of a tick of ``slots`` paths: the exact
        signature's, or the bucket's tick of all ``n_padded`` steps (other
        live counts capture at their first dispatch).  Changes no sample.
        Returns True when this call created the ``(key, n_ticks)`` entry,
        False when it existed.
        """
        if self.device.type == "cuda":
            solver = key.solver if isinstance(key, BucketKey) else key[0]
            for kernel in spec_kernels(solver, getattr(self.term, "noise",
                                                       "diagonal")):
                kernel.lib()
        fresh = not self.has_compiled(key, n_ticks)
        fn = self._stack_fn(key, n_ticks)
        if self._captures(fn):
            n_active = key.n_padded if isinstance(key, BucketKey) else None
            keys = torch.zeros((1, int(slots), 2), dtype=torch.int64,
                               device=self.device)
            with self.on_stream():
                self._graph(key, n_active, keys)
        return fresh

    def _graph(self, key, n_active: Optional[int], keys: torch.Tensor) -> _TickGraph:
        """The tick graph of ``(key, n_active)`` at ``keys``' slot count,
        captured on first use (one capture at a time in the process)."""
        gkey = (key, n_active, keys.shape[1])
        graph = self._graphs.get(gkey)
        if graph is None:
            with _CAPTURE_LOCK:
                graph = self._graphs.get(gkey)
                if graph is None:
                    one = self._stack_fn(key, 1)
                    run = one if n_active is None else (
                        lambda k: one(k, (n_active,)))
                    if self._pool is None:
                        self._pool = torch.cuda.graph_pool_handle()
                        self._capture_stream = torch.cuda.Stream(self.device)
                    graph = _TickGraph(run, keys, self._pool, self._capture_stream)
                    self._graphs[gkey] = graph
        return graph

    def _replay_ticks(self, key, tick_keys: torch.Tensor,
                      active_steps: Optional[Sequence[int]]):
        """A stack of ticks as replays of their tick graphs, each tick's
        outputs copied out of the graph pool before the next replay."""
        n_ticks = tick_keys.shape[0]
        outs = graph = None
        for t in range(n_ticks):
            keys = tick_keys[t:t + 1]
            graph = self._graph(key, None if active_steps is None
                                else int(active_steps[t]), keys)
            leaves = graph.replay(keys)
            self.n_replays += 1
            if outs is None:
                outs = [x.new_empty((n_ticks,) + tuple(x.shape[1:])) for x in leaves]
            for out, x in zip(outs, leaves):
                out[t].copy_(x[0])
        return tree_unflatten(graph.treedef, outs)

    def graph_stats(self) -> Dict[str, Any]:
        """``graphs`` captured, their ``capture_s`` in all, ``replays`` and
        ``pool_mib`` (device memory reserved while capturing: the shared
        pool's size)."""
        graphs = list(self._graphs.values())
        return {"graphs": len(graphs),
                "capture_s": sum(g.capture_seconds for g in graphs),
                "replays": self.n_replays,
                "pool_mib": sum(g.pool_bytes for g in graphs) / 2**20}

    def record_landing(self) -> Optional[torch.cuda.Event]:
        """Record (and keep as ``landing``) an event on ``stream`` after the
        work enqueued so far; None off CUDA."""
        if self.stream is None:
            return None
        self.landing = torch.cuda.Event()
        self.landing.record(self.stream)
        return self.landing

    @contextlib.contextmanager
    def on_stream(self):
        """Run the body under ``no_grad`` on the executor's stream, ordered
        after the caller's stream and before its later work."""
        with torch.no_grad():
            if self.stream is None:
                yield
                return
            caller = torch.cuda.current_stream(self.device)
            if caller != self.stream:
                self.stream.wait_stream(caller)
            with torch.cuda.stream(self.stream):
                yield
            if caller != self.stream:
                caller.wait_stream(self.stream)

    def dispatch(self, key: Union[Tuple, BucketKey], tick_keys: torch.Tensor,
                 active_steps: Optional[Sequence[int]] = None):
        """Run a ``(n_ticks, slots, 2)`` key stack; one host round trip.

        For a :class:`BucketKey`, ``active_steps`` gives each tick's live
        step count (host integers).  Returns the solve result with leading
        ``(n_ticks, slots)`` axes on every leaf, still on the device; its
        work is enqueued on ``stream`` ahead of the ``landing`` event.
        """
        n_ticks = tick_keys.shape[0]
        fn = self._stack_fn(key, n_ticks)
        bucketed = isinstance(key, BucketKey)
        if bucketed and active_steps is None:
            raise ValueError("bucketed dispatch needs active_steps")
        with self.on_stream():
            if self._captures(fn):
                if bucketed and len(active_steps) != n_ticks:
                    raise ValueError(
                        f"active_steps must give one live-step count per tick: "
                        f"{len(active_steps)} for {n_ticks} ticks")
                out = self._replay_ticks(key, tick_keys.to(self.device),
                                         active_steps if bucketed else None)
            elif bucketed:
                out = fn(tick_keys, active_steps)
            else:
                out = fn(tick_keys)
            self.record_landing()
        self.n_dispatches += 1
        self.n_ticks += n_ticks
        return out
