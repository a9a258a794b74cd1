"""Batched decode engine: fixed-slot continuous batching over ``serve_step``
(port of ``repro.serving.engine``).

Requests join free slots; every engine tick decodes one token for all live
slots in a single ``serve_step`` call.  Finished sequences (EOS or max
length) free their slot for the next queued request.  The semantics are the
reference's, including its simplifications: prompts prefill token by token,
all slots share one position per tick (the largest live slot position), and
a slot's cache is not cleared when a new request takes it.

On the card the engine captures ``serve_step`` once into a CUDA graph (the
batch shape is fixed by ``slots``) and every tick replays it, as the
reference jits the step: an eager step pays every op's launch on the host.  A
model whose DTensor parameters live on a mesh with a gloo process group
stays eager: gloo stages CUDA tensors through the host, which no graph can
hold.

Sampling: greedy by default; with ``greedy=False`` the next token is drawn
as ``jax.random.categorical`` draws it — the engine's threefry key (seed 0)
is split once per draw and the token is the argmax of Gumbel noise plus
``logits / temperature`` — so a seed names the reference's tokens up to
rounding in the noise's two logarithms.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Dict, List, Optional

import numpy as np
import torch

from ..core import prng
from ..core.pytree import tree_map
from ..kernels._build import GraphLaunches, capture_graph
from ..launch.mesh import graph_capturable
from ..models import ModelOptions, init_cache, make_serve_step
from ..models.transformer import _pin_cache
from ..spmd import is_dtensor

__all__ = ["ServeConfig", "Engine"]

_TINY = float(np.finfo(np.float32).tiny)


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    slots: int = 8
    max_len: int = 256
    eos_id: int = 1
    greedy: bool = True
    temperature: float = 1.0


@dataclasses.dataclass
class _Slot:
    request_id: Optional[int] = None
    pos: int = 0
    tokens: List[int] = dataclasses.field(default_factory=list)


def categorical(key, logits: torch.Tensor) -> int:
    """``jax.random.categorical(key, logits)`` for one row of float32 logits:
    ``argmax(-log(-log(u)) + logits)``, ``u`` uniform on ``[tiny, 1)``."""
    u = prng.uniform(key, tuple(logits.shape), torch.float32, _TINY, 1.0)
    return int(torch.argmax(-torch.log(-torch.log(u)) + logits))


class _DecodeGraph:
    """A decode step captured once into a CUDA graph and replayed.

    Called as the step it wraps, ``(params, cache, tokens, pos) -> (logits,
    cache)``.  The first call warms the step up on a clone of ``cache``
    (the step writes the KV rows and the Mamba2 states in place, so a
    warm-up on the live cache would advance a recurrence one extra step),
    then captures it on a side stream on static ``(slots,)`` token and 0-d
    position buffers, the graph writing into ``cache`` in place.  Every call
    copies ``tokens`` and ``pos`` in and replays; the logits it returns live
    in the graph's pool until the next call.  Only the ``params`` and
    ``cache`` it was captured with are accepted.  A capture that fails
    raises."""

    def __init__(self, step):
        self.step = step
        self.graph = None
        self.record = GraphLaunches()
        self.capture_seconds = None
        self.replays = 0

    def _capture(self, params, cache, tokens):
        device = tokens.device
        self.params, self.cache = params, cache
        self.tokens = tokens.clone()
        self.pos = torch.zeros((), dtype=torch.int64, device=device)
        start = time.perf_counter()
        self.step(params, tree_map(torch.clone, cache), self.tokens, self.pos)
        current, side = torch.cuda.current_stream(device), torch.cuda.Stream(device)
        side.wait_stream(current)
        graph, (self.logits, _) = capture_graph(
            lambda: self.step(params, cache, self.tokens, self.pos), self.record, side)
        current.wait_stream(side)
        self.graph = graph
        self.capture_seconds = time.perf_counter() - start

    def __call__(self, params, cache, tokens, pos):
        if self.graph is None:
            self._capture(params, cache, tokens)
        elif params is not self.params or cache is not self.cache:
            raise ValueError("a captured decode step reads the parameters and "
                             "writes the cache it was captured with")
        self.tokens.copy_(tokens)
        if isinstance(pos, torch.Tensor):
            self.pos.copy_(pos)
        else:
            self.pos.fill_(int(pos))
        self.graph.replay()
        self.record.replay()
        self.replays += 1
        return self.logits, cache


def _graph_capturable(params) -> bool:
    """Whether a decode step over ``params`` can be captured: every mesh its
    DTensor parameters live on runs NCCL."""
    meshes = {id(p.device_mesh): p.device_mesh for p in params.parameters()
              if is_dtensor(p)}
    return all(graph_capturable(m) for m in meshes.values())


class Engine:
    """The LM decode engine on the device of ``params``; dispatch runs
    under ``torch.no_grad()``.  ``graphed``: the step is replayed from a
    CUDA graph (``_step`` is then a ``_DecodeGraph``: its
    ``capture_seconds``, ``replays`` and ``record`` of captured
    launches)."""

    def __init__(self, cfg, params, serve_cfg: ServeConfig = ServeConfig(),
                 opts: ModelOptions = ModelOptions()):
        if not cfg.supports_decode:
            raise ValueError(f"{cfg.name} is encoder-only: no decode")
        self.cfg = cfg
        self.params = params
        self.sc = serve_cfg
        self.device = params["embed"].device
        self.cache = init_cache(cfg, serve_cfg.slots, serve_cfg.max_len,
                                device=self.device)
        # Lay the cache out before a capture, not inside it (a layout change
        # captured would copy the stale leaf over the cache on every replay).
        _pin_cache(self.cache, opts)
        self._step = make_serve_step(cfg, opts)
        self.graphed = self.device.type == "cuda" and _graph_capturable(params)
        if self.graphed:
            self._step = _DecodeGraph(self._step)
        self.slots = [_Slot() for _ in range(serve_cfg.slots)]
        self.queue: deque = deque()
        self.done: Dict[int, List[int]] = {}
        self._next_id = 0
        self.key = prng.PRNGKey(0, device="cpu")

    def submit(self, prompt_tokens: List[int]) -> int:
        rid = self._next_id
        self._next_id += 1
        self.queue.append((rid, list(prompt_tokens)))
        return rid

    def _admit(self):
        for slot in self.slots:
            if slot.request_id is None and self.queue:
                rid, prompt = self.queue.popleft()
                slot.request_id = rid
                slot.pos = 0
                slot.tokens = list(prompt)

    def tick(self) -> bool:
        """Advance every live slot by one token (prefill token by token
        too); False when no slot is live."""
        self._admit()
        live = [s for s in self.slots if s.request_id is not None]
        if not live:
            return False
        # One position counter per tick, as in the reference: the largest
        # live slot position; idle slots decode into it and are ignored.
        cur = np.zeros(self.sc.slots, np.int64)
        pos = 0
        for i, s in enumerate(self.slots):
            if s.request_id is not None:
                idx = min(s.pos, len(s.tokens) - 1)
                cur[i] = s.tokens[idx]
                pos = max(pos, s.pos)
        with torch.no_grad():
            logits, self.cache = self._step(
                self.params, self.cache, torch.from_numpy(cur).to(self.device), pos)
        logits = logits.cpu()
        for i, s in enumerate(self.slots):
            if s.request_id is None:
                continue
            if s.pos < len(s.tokens) - 1:
                s.pos += 1  # still prefilling
                continue
            if self.sc.greedy:
                nxt = int(np.argmax(logits[i].numpy()))
            else:
                self.key, sub = prng.split(self.key)
                nxt = categorical(sub, logits[i] / self.sc.temperature)
            s.tokens.append(nxt)
            s.pos += 1
            if nxt == self.sc.eos_id or len(s.tokens) >= self.sc.max_len:
                self.done[s.request_id] = s.tokens
                self.slots[i] = _Slot()
        return True

    def run(self, max_ticks: int = 10_000) -> Dict[int, List[int]]:
        for _ in range(max_ticks):
            if not self.tick() and not self.queue:
                break
        return self.done
