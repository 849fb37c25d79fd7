"""Coworker data pipeline: CPU preprocessing processes feeding trainers
through the native shared-memory ring (port of
``dlrover_tpu/trainer/shm_dataloader.py``).

Dedicated CPU processes run the user's preprocessing and publish ready
batches into shared memory; the trainer process never spends Python
time building batches. Transport is ``native/src/shm_ring.cc`` (C++, a
process-shared mutex ring), so the cost a batch in the trainer is one
memcpy. ``DevicePrefetcher`` then moves the batches to the card while
the step runs: ``trainer.data.DevicePreloader`` in background mode.

Coworkers are spawned, and a spawned process unpickles ``produce_fn``
by importing its module: keep that module's imports light (this module
imports torch only through ``trainer.data``).
"""

from __future__ import annotations

import multiprocessing as mp
import os
import time
import uuid
from typing import Any, Callable, Dict, Iterator, Optional

import numpy as np

from dlrover_tpu_torch.common.log import get_logger
from dlrover_tpu_torch.native.shm_ring import (
    DONE_KEY,
    RingClosed,
    RingTimeout,
    ShmBatchRing,
    producer_main,
)
from dlrover_tpu_torch.trainer.data import DevicePreloader

logger = get_logger("trainer.shm")


class ShmDataLoader:
    """Iterator over batches produced by ``num_workers`` coworker
    processes.

    ``produce_fn(worker_rank, num_workers)`` must be a picklable callable
    yielding dict-of-numpy batches; workers partition the work by rank
    (same contract as torch DataLoader worker sharding).
    """

    def __init__(
        self,
        produce_fn: Callable[[int, int], Iterator[Dict[str, np.ndarray]]],
        num_workers: int = 1,
        slot_bytes: int = 1 << 22,
        n_slots: int = 8,
        name: Optional[str] = None,
        timeout: float = 120.0,
    ):
        self._timeout = timeout
        # a name no other process or loader holds: /dev/shm is one
        # namespace for the whole machine
        self.name = name or (f"/dlrover_torch_shm_{os.getpid()}_"
                             f"{uuid.uuid4().hex[:12]}")
        self._ring = ShmBatchRing(
            self.name, slot_bytes=slot_bytes, n_slots=n_slots, owner=True
        )
        ctx = mp.get_context("spawn")
        self._workers = [
            ctx.Process(
                target=producer_main,
                args=(self.name, produce_fn, rank, num_workers),
                daemon=True,
            )
            for rank in range(num_workers)
        ]
        for w in self._workers:
            w.start()

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        done = 0
        while True:
            try:
                batch = self._ring.get(timeout=self._timeout)
            except RingClosed:
                return
            except RingTimeout:
                if not any(w.is_alive() for w in self._workers):
                    logger.warning(
                        "all shm producers died; ending stream"
                    )
                    return
                raise
            if DONE_KEY in batch:
                done += 1
                if done == len(self._workers):
                    self._ring.close()
                    return
                continue
            yield batch

    def qsize(self) -> int:
        return self._ring.qsize()

    def shutdown(self, timeout: float = 5.0) -> bool:
        """Close the ring, join the coworkers within ``timeout`` seconds
        (terminating any still alive then) and free the segment. True
        when every coworker ended on its own with exit code 0."""
        self._ring.close()
        deadline = time.monotonic() + timeout
        clean = True
        for w in self._workers:
            w.join(timeout=max(0.0, deadline - time.monotonic()))
            if w.is_alive():
                clean = False
                w.terminate()
                w.join(timeout=5)
            clean = clean and w.exitcode == 0
        self._ring.free()
        return clean

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.shutdown()


class DevicePrefetcher(DevicePreloader):
    """Overlap the host-to-device copy with compute: ``depth`` batches in
    flight on a background thread, the shm path's face of
    ``trainer.data.DevicePreloader`` in background mode. Without
    ``put_fn`` the batches go through the preloader's pinned arena and
    copy stream onto ``device`` (``cuda`` by default).

    It keeps the base's data-plane instruments: a coworker ring that
    stops keeping up shows as consumer-wait time and a queue depth
    pinned at 0 (the input-bound signature)."""

    def __init__(self, batches: Iterator[Any],
                 put_fn: Optional[Callable[[Any], Any]] = None,
                 depth: int = 2, device=None):
        super().__init__(batches, prefetch=depth, put_fn=put_fn,
                         background=True, device=device)
