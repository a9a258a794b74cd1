"""Roofline terms of one rank's step on the H100, counted op by op (port of
``repro.launch.roofline``).

Per (arch x shape x mesh) cell the dry run derives the three-term roofline
of one rank (every quantity is that rank's own, as the reference reads it
from the SPMD-partitioned module)::

    compute_s    = flops            / PEAK_FLOPS   (989 TFLOP/s bf16, H100 SXM)
    memory_s     = bytes            / HBM_BW       (3.35 TB/s)
    collective_s = collective bytes / LINK_BW      (450 GB/s, NVLink 4)

The reference reads XLA's ``cost_analysis`` and parses the compiled HLO for
its collectives.  Torch compiles nothing, so :class:`CostCounter`, a
``TorchDispatchMode``, counts the aten ops that a step runs (on fake tensors
in the dry run; on real ones as well):

* ``flops``: ``torch.utils.flop_counter``'s formulas on each op's shapes;
* ``bytes``: every op's input plus output bytes, views and allocations
  without data left out (the pre-fusion count XLA's "bytes accessed" is);
* ``transcendentals``: the elements that ``exp``, ``log``, ``tanh``,
  ``sigmoid``, ``rsqrt``, ``erf`` and their kin produce;
* the result bytes of each collective by kind, from the functional
  collectives DTensor issues (``_c10d_functional.*``) and the plain
  ``c10d`` ops alike, with their ``count``.

**Per rank.**  An op on DTensors is left to DTensor (the mode returns
``NotImplemented``), which runs it on this rank's local shards; the mode
counts those local ops and the collectives between them.  Counting the
DTensor op itself (as ``FlopCounterMode`` does) gives the global figure.
DTensor's sharding propagation runs each new op once on fake tensors of the
global shapes to learn the output's shape; the counter skips what runs
there.

With ``track_memory`` the counter also follows the live bytes of every
storage an op creates (a weak reference's finalizer subtracts it when the
storage is freed) and keeps their peak: with :func:`memory_summary` that
gives the reference's memory record of a traced step.
"""
from __future__ import annotations

import contextlib
import dataclasses
import sys
import weakref
from typing import Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

__all__ = ["PEAK_FLOPS", "HBM_BW", "LINK_BW", "COLLECTIVES", "CostCounter",
           "Roofline", "analyze", "memory_summary"]

PEAK_FLOPS = 989e12  # H100 SXM, bf16 dense on the tensor cores (NVIDIA data sheet)
HBM_BW = 3.35e12  # H100 SXM, HBM3 B/s (NVIDIA data sheet)
LINK_BW = 450e9  # H100 SXM, NVLink 4: 900 GB/s a GPU, 450 GB/s each way (data sheet)

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")

_KIND = {
    # the functional collectives (DTensor's redistributions)
    "_c10d_functional.all_reduce": "all-reduce",
    "_c10d_functional.all_reduce_": "all-reduce",
    "_c10d_functional.all_reduce_coalesced": "all-reduce",
    "_c10d_functional.all_reduce_coalesced_": "all-reduce",
    "_c10d_functional.all_gather_into_tensor": "all-gather",
    "_c10d_functional.all_gather_into_tensor_out": "all-gather",
    "_c10d_functional.all_gather_into_tensor_coalesced": "all-gather",
    "_c10d_functional.reduce_scatter_tensor": "reduce-scatter",
    "_c10d_functional.reduce_scatter_tensor_coalesced": "reduce-scatter",
    "_c10d_functional.all_to_all_single": "all-to-all",
    "_c10d_functional.isend": "collective-permute",
    "_c10d_functional.irecv": "collective-permute",
    # the plain c10d ops (torch.distributed's calls); their results are
    # their first argument's tensors
    "c10d.allreduce_": "all-reduce",
    "c10d.allreduce_coalesced_": "all-reduce",
    "c10d.allgather_": "all-gather",
    "c10d._allgather_base_": "all-gather",
    "c10d.allgather_coalesced_": "all-gather",
    "c10d.allgather_into_tensor_coalesced_": "all-gather",
    "c10d.reduce_scatter_": "reduce-scatter",
    "c10d._reduce_scatter_base_": "reduce-scatter",
    "c10d.reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "c10d.alltoall_": "all-to-all",
    "c10d.alltoall_base_": "all-to-all",
    "c10d.send": "collective-permute",
    "c10d.recv_": "collective-permute",
}

# ops that move no data: allocations, metadata, waits
_NO_DATA = {"aten.empty", "aten.empty_strided", "aten.empty_like", "aten.new_empty",
            "aten.new_empty_strided", "aten._unsafe_view", "aten.lift_fresh", "prim.device",
            "_c10d_functional.wait_tensor"}

# ops whose every output element costs a transcendental function
_TRANSCENDENTAL = {
    "aten." + n for n in (
        "exp", "exp_", "exp2", "expm1", "log", "log_", "log1p", "log2", "log10", "tanh",
        "tanh_", "sigmoid", "sigmoid_", "rsqrt", "rsqrt_", "sqrt", "sqrt_", "erf", "erf_",
        "erfc", "erfinv", "sin", "cos", "pow", "pow_", "silu", "silu_", "silu_backward",
        "gelu", "gelu_backward", "softplus", "softplus_backward", "logaddexp", "_softmax",
        "_log_softmax", "_log_softmax_backward_data", "logsumexp")}


def _bytes(t: torch.Tensor) -> int:
    """The logical bytes of ``t`` (its elements, not its storage)."""
    return t.numel() * t.element_size()


def _tensors(tree):
    """The tensors of a tree whose nodes may be modules (their parameters)."""
    leaves = tree_leaves(tree, is_leaf=lambda x: isinstance(x, torch.nn.Module))
    return [t for x in leaves
            for t in (x.parameters() if isinstance(x, torch.nn.Module) else (x,))
            if isinstance(t, torch.Tensor)]


def _local(t: torch.Tensor) -> torch.Tensor:
    return t.to_local() if hasattr(t, "to_local") and hasattr(t, "placements") else t


def _storage_key(t: torch.Tensor):
    return t.untyped_storage()._cdata


def _local_bytes(tree) -> int:
    """Bytes of the distinct storages of the tensors of ``tree`` on this
    rank (a DTensor's local shard), each counted once; a storage shared by
    two leaves (a view) is one."""
    seen = {}
    for t in _tensors(tree):
        t = _local(t)
        seen.setdefault(_storage_key(t), t.untyped_storage().nbytes())
    return sum(seen.values())


@contextlib.contextmanager
def _skipped_propagation(counter):
    """DTensor's sharding propagation, while inside, runs uncounted: it runs
    an op on fake tensors of the global shapes to learn its output's, which
    is not this rank's work."""
    try:
        from torch.distributed.tensor._sharding_prop import ShardingPropagator
    except ImportError:  # no DTensor: nothing to skip
        yield
        return
    name = "_propagate_tensor_meta_non_cached"
    if not hasattr(ShardingPropagator, name):
        name = "_propagate_tensor_meta"
    inner = getattr(ShardingPropagator, name)

    def propagate(self, *args, **kwargs):
        counter._skip += 1
        try:
            return inner(self, *args, **kwargs)
        finally:
            counter._skip -= 1

    setattr(ShardingPropagator, name, propagate)
    try:
        yield
    finally:
        setattr(ShardingPropagator, name, inner)


class CostCounter(TorchDispatchMode):
    """This rank's flops, bytes, transcendentals and collective result
    bytes of the ops run while active (see the module doc); with
    ``track_memory`` also the live and peak bytes of the storages they
    create.  Counters add up over every ``with`` block."""

    def __init__(self, *, track_memory: bool = False):
        super().__init__()
        from torch.utils.flop_counter import flop_registry

        self._formulas = flop_registry
        self.flops = 0
        self.bytes = 0
        self.transcendentals = 0
        self.coll = dict.fromkeys(COLLECTIVES, 0)
        self.coll["count"] = 0
        self.track_memory = track_memory
        self.live = 0
        self.peak = 0
        self._held = {}
        self._skip = 0
        self._patch = None

    def __enter__(self):
        self._patch = _skipped_propagation(self)
        self._patch.__enter__()
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self._patch.__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        dtensor = sys.modules.get("torch.distributed.tensor")
        if dtensor is not None and any(issubclass(t, dtensor.DTensor) for t in types):
            return NotImplemented  # DTensor runs it on the local shards
        out = func(*args, **kwargs)
        if not self._skip:
            self._count(func, args, kwargs, out)
        return out

    def _count(self, func, args, kwargs, out) -> None:
        name = func._overloadpacket._qualified_op_name.replace("::", ".")
        formula = self._formulas.get(func._overloadpacket)
        if formula is not None:
            self.flops += int(formula(*args, **kwargs, out_val=out))
        kind = _KIND.get(name)
        if kind is not None:
            result = args[0] if name.startswith("c10d.") else out
            self.coll[kind] += sum(_bytes(t) for t in _tensors(result))
            self.coll["count"] += 1
        outs = _tensors(out)
        if not func.is_view and name not in _NO_DATA:
            self.bytes += sum(_bytes(t) for t in _tensors((args, kwargs)) + outs)
        if name in _TRANSCENDENTAL:
            self.transcendentals += sum(t.numel() for t in outs)
        if self.track_memory:
            inputs = {_storage_key(t) for t in _tensors((args, kwargs))}
            for t in outs:
                self._hold(t, inputs)

    def _hold(self, t: torch.Tensor, inputs) -> None:
        storage = t.untyped_storage()
        key, nbytes = storage._cdata, storage.nbytes()
        if nbytes == 0 or key in self._held or key in inputs:  # a view, in place
            return
        self._held[key] = nbytes
        self.live += nbytes
        self.peak = max(self.peak, self.live)
        weakref.finalize(storage, self._release, key)

    def _release(self, key) -> None:
        self.live -= self._held.pop(key)

    def collective_bytes(self) -> Dict[str, int]:
        """Result bytes by collective kind and their ``count`` (the
        reference's ``collective_bytes`` record)."""
        return dict(self.coll)

    def cost(self) -> Dict[str, float]:
        """The reference's cost record: flops, bytes, transcendentals and
        the collectives' result bytes summed (``coll``)."""
        return {"flops": float(self.flops), "bytes": float(self.bytes),
                "transcendentals": float(self.transcendentals),
                "coll": float(sum(v for k, v in self.coll.items() if k != "count"))}


@dataclasses.dataclass
class Roofline:
    flops: float  # per device
    bytes_accessed: float  # per device
    coll_bytes: float  # per device
    coll_breakdown: Dict[str, int]
    compute_s: float
    memory_s: float
    collective_s: float
    dominant: str
    model_flops: Optional[float] = None  # 6 N D (global, useful-work estimate)
    useful_ratio: Optional[float] = None
    peak_fraction: Optional[float] = None  # compute_s / max(all terms)

    def to_dict(self):
        return dataclasses.asdict(self)


def analyze(counter: CostCounter, *, n_devices: int,
            model_flops: Optional[float] = None) -> Roofline:
    """The three roofline terms of what ``counter`` counted on one rank."""
    cost = counter.cost()
    flops, byts, cbytes = cost["flops"], cost["bytes"], cost["coll"]
    compute_s = flops / PEAK_FLOPS
    memory_s = byts / HBM_BW
    collective_s = cbytes / LINK_BW
    terms = {"compute": compute_s, "memory": memory_s, "collective": collective_s}
    dominant = max(terms, key=terms.get)
    useful = None
    if model_flops:
        useful = model_flops / (flops * n_devices) if flops else None
    return Roofline(
        flops=flops,
        bytes_accessed=byts,
        coll_bytes=cbytes,
        coll_breakdown=counter.collective_bytes(),
        compute_s=compute_s,
        memory_s=memory_s,
        collective_s=collective_s,
        dominant=dominant,
        model_flops=model_flops,
        useful_ratio=useful,
        peak_fraction=compute_s / max(max(terms.values()), 1e-30),
    )


def memory_summary(counter: CostCounter, *, arguments, outputs) -> Dict[str, float]:
    """The reference's memory record of a step traced under ``counter``
    (``track_memory=True``) with ``arguments`` live throughout and
    ``outputs`` its results:

    * ``argument_size_in_bytes``: the arguments' local bytes;
    * ``output_size_in_bytes``: the outputs' local bytes;
    * ``alias_size_in_bytes``: the outputs' bytes that are arguments'
      storages (updated in place: the parameters of a training step, a
      decode step's caches), the port's donated buffers;
    * ``temp_size_in_bytes``: the peak's excess over what is live at the
      end (the arguments and the new outputs);
    * ``generated_code_size_in_bytes``: 0 (nothing is compiled);
    * ``total_hbm_bytes``: argument + output + temp - alias, the peak of
      the live bytes over the step.
    """
    arg_keys = {_storage_key(_local(t)) for t in _tensors(arguments)}
    arg = float(_local_bytes(arguments))
    out = float(_local_bytes(outputs))
    alias = float(_local_bytes([t for t in _tensors(outputs)
                               if _storage_key(_local(t)) in arg_keys]))
    temp = max(counter.peak - (out - alias), 0.0)
    return {
        "argument_size_in_bytes": arg,
        "output_size_in_bytes": out,
        "temp_size_in_bytes": float(temp),
        "generated_code_size_in_bytes": 0.0,
        "alias_size_in_bytes": alias,
        "total_hbm_bytes": arg + out + temp - alias,
    }
