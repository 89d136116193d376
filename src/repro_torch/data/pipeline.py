"""Deterministic, resumable, host-sharded synthetic token pipeline
(counterpart of repro.data.pipeline; the numpy stream is the reference's,
so ``batch_at`` gives its batches bit for bit).

Every batch is a pure function of (seed, step, process_index): a
counter-based PRNG stream. So a restart at step N reproduces the same batch
stream with no loader state in the checkpoint beyond the step, and a
relaunch at another process count re-slices the same global stream. The
prefetch thread keeps batches ahead of the step and, given a device, copies
them there from pinned memory without blocking the host.

The synthetic distribution is a Zipfian unigram mix with in-sequence
repetition structure, so cross-entropy falls during the example training
runs (a learnable signal, unlike uniform noise).
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Iterator, Optional

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_alpha: float = 1.1
    repeat_prob: float = 0.3       # probability of copying an earlier token
    repeat_window: int = 32


class SyntheticLM:
    """Counter-based deterministic batch source."""

    def __init__(self, cfg: DataConfig, *, process_index: int = 0,
                 process_count: int = 1):
        if cfg.global_batch % process_count:
            raise ValueError(f"global batch {cfg.global_batch} does not split "
                             f"over {process_count} processes")
        self.cfg = cfg
        self.process_index = process_index
        self.process_count = process_count
        self.local_batch = cfg.global_batch // process_count
        # Zipf unigram table (truncated, normalised)
        ranks = np.arange(1, cfg.vocab + 1, dtype=np.float64)
        p = ranks ** (-cfg.zipf_alpha)
        self._probs = p / p.sum()

    def batch_at(self, step: int) -> dict[str, np.ndarray]:
        cfg = self.cfg
        rng = np.random.default_rng(
            np.random.SeedSequence([cfg.seed, step, self.process_index]))
        b, s = self.local_batch, cfg.seq_len
        tokens = rng.choice(cfg.vocab, size=(b, s), p=self._probs)
        # structured repetition: copy a recent token with repeat_prob
        rep = rng.random((b, s)) < cfg.repeat_prob
        offs = rng.integers(1, cfg.repeat_window, size=(b, s))
        idx = np.maximum(np.arange(s)[None, :] - offs, 0)
        tokens = np.where(rep, np.take_along_axis(tokens, idx, axis=1), tokens)
        return {"tokens": tokens.astype(np.int32)}

    def iterate(self, start_step: int = 0) -> Iterator[dict[str, np.ndarray]]:
        step = start_step
        while True:
            yield self.batch_at(step)
            step += 1


def to_device(batch: dict[str, np.ndarray], device: torch.device) -> dict:
    """A numpy batch as tensors on ``device``: to the card from pinned
    memory, without blocking the host (the reference's ``device_put``)."""
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(v)
        out[k] = (t.pin_memory().to(device, non_blocking=True)
                  if device.type == "cuda" else t.to(device))
    return out


class Prefetcher:
    """Background prefetch of ``depth`` batches, as numpy arrays or, given
    ``device``, as tensors placed there (``to_device``)."""

    def __init__(self, source: SyntheticLM, *, start_step: int = 0,
                 device: Optional[torch.device] = None, depth: int = 2):
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        dev = None if device is None else torch.device(device)

        def worker():
            it = source.iterate(start_step)
            while not self._stop.is_set():
                batch = next(it)
                if dev is not None:
                    batch = to_device(batch, dev)
                self._q.put(batch)

        self._thread = threading.Thread(target=worker, daemon=True)
        self._thread.start()

    def __iter__(self):
        return self

    def __next__(self):
        return self._q.get()

    def close(self):
        """Stop the worker: drain the queue so that a ``put`` it waits in
        returns, then join it."""
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=60)
