"""Deterministic synthetic token batches (port of ``repro.data.pipeline``).

* **Deterministic by (step, host)**: :meth:`SyntheticTokens.batch_at` is a
  pure function of the global step and the host's shard, so a restart from
  a checkpoint replays the exact stream (no loader state in checkpoints);
  its numpy arrays equal the reference's bit for bit.
* **Host-sharded**: each process makes only its ``1 / num_hosts`` slice of
  the global batch.
* :func:`prefetch` — a small lookahead queue filled by a thread, so host-side
  generation overlaps device steps.

Batches are numpy arrays; the train loop moves them to the device.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Dict, Iterator

import numpy as np

__all__ = ["DataConfig", "SyntheticTokens", "prefetch"]


@dataclasses.dataclass(frozen=True)
class DataConfig:
    global_batch: int
    seq_len: int
    vocab: int
    seed: int = 0
    num_hosts: int = 1
    host_id: int = 0


class SyntheticTokens:
    """Deterministic pseudo-corpus: ``batch_at(step)`` is pure in
    ``(cfg, step)``."""

    def __init__(self, cfg: DataConfig):
        if cfg.global_batch % cfg.num_hosts:
            raise ValueError(f"global_batch={cfg.global_batch} is not a "
                             f"multiple of num_hosts={cfg.num_hosts}")
        self.cfg = cfg
        self.local_batch = cfg.global_batch // cfg.num_hosts

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        rows = []
        with np.errstate(over="ignore"):  # the hash wraps modulo 2**64
            base = np.uint64(cfg.seed) * np.uint64(0x9E3779B97F4A7C15)
        for i in range(self.local_batch):
            gseq = step * cfg.global_batch + cfg.host_id * self.local_batch + i
            rng = np.random.default_rng(np.uint64(gseq) ^ base)
            rows.append(rng.integers(0, cfg.vocab, size=cfg.seq_len + 1,
                                     dtype=np.int32))
        arr = np.stack(rows)
        return {
            "tokens": arr[:, :-1],
            "labels": arr[:, 1:],
            "loss_mask": np.ones((self.local_batch, cfg.seq_len), np.float32),
        }

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


def prefetch(it: Iterator, depth: int = 2) -> Iterator:
    """Host-side lookahead buffer of ``depth`` items, filled by a daemon
    thread (generation overlaps the consumer's device steps)."""
    q: queue.Queue = queue.Queue(maxsize=depth)
    stop = object()
    failure = []

    def worker():
        try:
            for item in it:
                q.put(item)
        except Exception as exc:  # handed to the consumer, raised there
            failure.append(exc)
        finally:
            q.put(stop)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    while True:
        item = q.get()
        if item is stop:
            if failure:
                raise failure[0]
            return
        yield item
