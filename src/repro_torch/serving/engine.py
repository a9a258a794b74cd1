"""Batched decode engine: fixed-slot continuous batching over ``serve_step``
(port of ``repro.serving.engine``).

Requests join free slots; every engine tick decodes one token for all live
slots in a single ``serve_step`` call.  Finished sequences (EOS or max
length) free their slot for the next queued request.  The semantics are the
reference's, including its simplifications: prompts prefill token by token,
all slots share one position per tick (the largest live slot position), and
a slot's cache is not cleared when a new request takes it.

Sampling: greedy by default; with ``greedy=False`` the next token is drawn
as ``jax.random.categorical`` draws it — the engine's threefry key (seed 0)
is split once per draw and the token is the argmax of Gumbel noise plus
``logits / temperature`` — so a seed names the reference's tokens up to
rounding in the noise's two logarithms.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Dict, List, Optional

import numpy as np
import torch

from ..core import prng
from ..models import ModelOptions, init_cache, make_serve_step

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


class Engine:
    """The LM decode engine on the device of ``params``; dispatch runs
    under ``torch.no_grad()``."""

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
        self._step = make_serve_step(cfg, opts)
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
