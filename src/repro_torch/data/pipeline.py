"""Deterministic sharded data pipeline with prefetch (a copy of
:mod:`repro.data.pipeline`: numpy only, so a batch is byte-identical to
the JAX package's for the same ``(seed, step, host)``).

Properties needed at 1000+ nodes:
  * **determinism** — batch content is a pure function of (seed, step, host),
    so a restarted/elastically-rescaled job replays exactly the same stream
    from its restored step (no data loss/duplication across preemptions);
  * **host sharding** — each host synthesizes only its slice of the global
    batch (no central dispenser to fail or bottleneck);
  * **prefetch** — a background thread keeps `prefetch` batches ready so the
    accelerator never waits on the host (straggler mitigation at the input
    layer);
  * synthetic token source here (the framework's data substrate is the
    pipeline mechanics, not a corpus); the `TokenSource` interface is where a
    real corpus reader would plug in.
"""
from __future__ import annotations

import queue
import threading
from typing import Iterator

import numpy as np

from ..configs.base import ArchConfig


class TokenSource:
    """Deterministic synthetic corpus: tokens = f(seed, step, host)."""

    def __init__(self, cfg: ArchConfig, seed: int = 0):
        self.cfg = cfg
        self.seed = seed

    def batch(self, step: int, host: int, batch_size: int, seq_len: int) -> dict:
        root = np.random.SeedSequence([self.seed, step, host])
        rng = np.random.default_rng(root)
        cfg = self.cfg
        out: dict[str, np.ndarray] = {}
        if cfg.family == "vlm":
            P = min(cfg.frontend_tokens, max(seq_len // 2, 1))
            toks = rng.integers(0, cfg.vocab_size, (batch_size, seq_len - P),
                                dtype=np.int32)
            out["patches"] = rng.standard_normal(
                (batch_size, P, cfg.d_model), dtype=np.float32)
        elif cfg.family == "audio":
            toks = rng.integers(0, cfg.vocab_size, (batch_size, seq_len),
                                dtype=np.int32)
            out["frames"] = rng.standard_normal(
                (batch_size, cfg.encoder_seq_len, cfg.d_model), dtype=np.float32)
        else:
            toks = rng.integers(0, cfg.vocab_size, (batch_size, seq_len),
                                dtype=np.int32)
        out["tokens"] = toks
        out["labels"] = np.roll(toks, -1, axis=1)
        return out


class DataPipeline:
    """Prefetching iterator over per-host batch shards."""

    def __init__(self, source: TokenSource, *, global_batch: int, seq_len: int,
                 num_hosts: int = 1, host_index: int = 0,
                 start_step: int = 0, prefetch: int = 2):
        assert global_batch % num_hosts == 0
        self.source = source
        self.per_host = global_batch // num_hosts
        self.seq_len = seq_len
        self.host = host_index
        self.step = start_step
        self.prefetch = prefetch
        self._q: queue.Queue = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self) -> None:
        step = self.step
        while not self._stop.is_set():
            batch = self.source.batch(step, self.host, self.per_host, self.seq_len)
            batch["_step"] = step
            while not self._stop.is_set():
                try:
                    self._q.put(batch, timeout=0.2)
                    break
                except queue.Full:
                    continue
            step += 1

    def __iter__(self) -> Iterator[dict]:
        return self

    def __next__(self) -> dict:
        return self._q.get()

    def close(self) -> None:
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
