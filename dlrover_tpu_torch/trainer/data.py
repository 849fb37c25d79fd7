"""Elastic data input (port of ``dlrover_tpu/trainer/data.py``): the
resumable sampler, the loader whose batch size changes at a batch
boundary, ``stack_batches`` for the fused multi-step call, and
``DevicePreloader``, the one host-to-device prefetcher of both data
paths (the in-process loader and the shm coworker ring).

Each host feeds its own slice of the global batch: the sampler
partitions the index space by (num_shards, shard_rank), and resuming
after a change of world re-partitions the remaining indices over the
new world. With a sharding client (anything with ``record_indices()``)
the client's indices replace the sampler's.

On ``cuda`` the preloader stages each batch in a pinned host arena,
allocated once (``prefetch + 1`` slots per key and shape) and reused
from batch to batch, copies it to the card on a stream of its own, and
hands it to the consumer behind an event: the consumer's stream waits
on it, and each delivered tensor is marked as used on that stream
(``record_stream``), so the caching allocator does not give its block
to a later copy while the step still reads it. A slot is refilled only
after the copy that last read it has completed.
"""

from __future__ import annotations

import collections
import math
import queue as _queue
import threading
import time
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence

import numpy as np
import torch

from dlrover_tpu_torch.common.device import DeviceLike, resolve_device
from dlrover_tpu_torch.common.log import get_logger
from dlrover_tpu_torch.telemetry import get_registry, names as tm

logger = get_logger("trainer.data")


class ElasticDistributedSampler:
    """Deterministic, resumable index sampler over ``dataset_size``.

    ``state_dict``/``load_state_dict`` carry ``completed_num`` so a
    restore (possibly at another world size) skips consumed samples.
    """

    def __init__(
        self,
        dataset_size: int,
        num_shards: int = 1,
        shard_rank: int = 0,
        shuffle: bool = True,
        seed: int = 0,
        drop_last: bool = False,
    ):
        if num_shards < 1 or not 0 <= shard_rank < num_shards:
            raise ValueError(
                f"bad shard spec rank={shard_rank} of {num_shards}"
            )
        self.dataset_size = dataset_size
        self.num_shards = num_shards
        self.shard_rank = shard_rank
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.epoch = 0
        self.completed_num = 0  # global count of consumed samples

    def set_epoch(self, epoch: int):
        self.epoch = epoch
        self.completed_num = 0

    def _global_indices(self) -> np.ndarray:
        idx = np.arange(self.dataset_size)
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self.epoch)
            rng.shuffle(idx)
        return idx

    def __iter__(self) -> Iterator[int]:
        indices = self._global_indices()[self.completed_num:]
        if self.drop_last:
            usable = (len(indices) // self.num_shards) * self.num_shards
            indices = indices[:usable]
        else:
            pad = (-len(indices)) % self.num_shards
            if pad and len(indices) > 0:
                # tile until the pad is covered: near an epoch's end the
                # remainder can be smaller than the pad, and every shard
                # must yield the same count or the ranks fall out of step
                reps = -(-pad // len(indices))
                filler = np.tile(indices, reps)[:pad]
                indices = np.concatenate([indices, filler])
        for i in indices[self.shard_rank:: self.num_shards]:
            yield int(i)

    def __len__(self) -> int:
        remaining = self.dataset_size - self.completed_num
        if self.drop_last:
            return remaining // self.num_shards
        return math.ceil(remaining / self.num_shards)

    def record_batch(self, global_batch_size: int):
        """Advance the resume cursor by one global batch."""
        self.completed_num += global_batch_size

    def reshard(self, num_shards: int, shard_rank: int):
        """Adopt a new world; the remaining indices re-partition."""
        logger.info(
            "sampler reshard: %d/%d -> %d/%d (completed=%d)",
            self.shard_rank, self.num_shards, shard_rank, num_shards,
            self.completed_num,
        )
        self.num_shards = num_shards
        self.shard_rank = shard_rank

    def state_dict(self) -> dict:
        return {
            "epoch": self.epoch,
            "completed_num": self.completed_num,
            "seed": self.seed,
        }

    def load_state_dict(self, state: dict):
        self.epoch = state.get("epoch", 0)
        self.completed_num = state.get("completed_num", 0)
        self.seed = state.get("seed", self.seed)


class ElasticDataLoader:
    """Batched host-side loader with a batch size adjustable at run
    time.

    ``dataset`` is anything indexable; ``collate_fn`` stacks samples
    (default: ``np.stack`` leaf by leaf over dicts of arrays).
    ``set_batch_size`` takes effect at the next batch boundary. Every
    batch has the same leading size: ``drop_last=False`` pads the last
    batch by repeating its samples instead of emitting a short one.
    """

    def __init__(
        self,
        dataset: Sequence,
        batch_size: int,
        sampler: Optional[ElasticDistributedSampler] = None,
        collate_fn: Optional[Callable[[List[Any]], Any]] = None,
        sharding_client=None,
        drop_last: bool = True,
    ):
        self.dataset = dataset
        self._batch_size = batch_size
        self.sampler = sampler or ElasticDistributedSampler(
            len(dataset), shuffle=False
        )
        self._collate = collate_fn or _default_collate
        # when set, indices come from the sharding client's
        # record_indices() instead of the static sampler
        self._sharding_client = sharding_client
        self._drop_last = drop_last

    @property
    def batch_size(self) -> int:
        return self._batch_size

    def set_batch_size(self, batch_size: int):
        if batch_size > 0 and batch_size != self._batch_size:
            logger.info("batch size %d -> %d", self._batch_size, batch_size)
            self._batch_size = batch_size

    def _index_stream(self) -> Iterator[int]:
        if self._sharding_client is not None:
            yield from self._sharding_client.record_indices()
        else:
            yield from self.sampler

    def __iter__(self) -> Iterator[Any]:
        buf: List[Any] = []
        for idx in self._index_stream():
            buf.append(self.dataset[idx])
            if len(buf) == self._batch_size:
                yield self._collate(buf)
                buf.clear()
        if buf and not self._drop_last:
            while len(buf) < self._batch_size:  # pad to the fixed shape
                buf.extend(buf[: self._batch_size - len(buf)])
            yield self._collate(buf[: self._batch_size])

    def __len__(self) -> int:
        n, bs = len(self.sampler), max(self._batch_size, 1)
        return n // bs if self._drop_last else -(-n // bs)


def stack_batches(batches: List[Dict]) -> Dict:
    """Stack K host batches (dicts of numpy arrays or tensors) along a
    new leading axis, key by key: the input of ``accelerate``'s
    ``train_step_multi``. K batches that one result's ``shard_batch``
    placed stack into a batch placed by it too."""
    if not batches:
        raise ValueError("stack_batches needs at least one batch")
    out = {}
    for key in batches[0]:
        values = [b[key] for b in batches]
        if isinstance(values[0], torch.Tensor):
            out[key] = torch.stack(values)
        else:
            out[key] = np.stack([np.asarray(v) for v in values])
    owner = getattr(batches[0], "placed_by", None)
    if owner is not None and all(
            getattr(b, "placed_by", None) is owner and not b.stacked
            for b in batches):
        return type(batches[0])(out, owner, stacked=True)
    return out


def _default_collate(samples: List[Any]):
    """Stack samples leaf by leaf: dicts (and lists or tuples) of arrays
    or numbers become the same structure of stacked arrays."""
    first = samples[0]
    if isinstance(first, dict):
        return {k: _default_collate([s[k] for s in samples]) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(_default_collate(list(leaves))
                           for leaves in zip(*samples))
    return np.stack(samples)


def _tensors(tree) -> Iterator[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


class _PinnedArena:
    """Pinned host slots, ``n_slots`` per (key, shape, dtype), each
    allocated at its first use and refilled round robin. ``stage``
    waits, before refilling a slot, for the event of the copy that last
    read it."""

    def __init__(self, n_slots: int):
        self._n = n_slots
        self._slots: Dict[tuple, List[torch.Tensor]] = {}
        self._events: Dict[tuple, List[Optional[torch.cuda.Event]]] = {}
        self._next: Dict[tuple, int] = {}

    def stage(self, key: str, value) -> tuple:
        src = torch.as_tensor(np.ascontiguousarray(value)
                              if isinstance(value, np.ndarray) else value)
        spec = (key, tuple(src.shape), src.dtype)
        slots = self._slots.get(spec)
        if slots is None:
            slots = self._slots[spec] = [
                torch.empty(src.shape, dtype=src.dtype, pin_memory=True)
                for _ in range(self._n)]
            self._events[spec] = [None] * self._n
            self._next[spec] = 0
        i = self._next[spec]
        self._next[spec] = (i + 1) % self._n
        event = self._events[spec][i]
        if event is not None:
            event.synchronize()  # the copy that last read the slot is done
        slots[i].copy_(src)
        return slots[i], (spec, i)

    def mark(self, handles: List[tuple], event: torch.cuda.Event):
        for spec, i in handles:
            self._events[spec][i] = event

    def slot_count(self) -> int:
        return sum(len(s) for s in self._slots.values())


class DevicePreloader:
    """Overlap the host-to-device copy of the next batches with the
    step: the one prefetcher of the in-process loader and of the shm
    coworker ring, which wraps it in background mode.

    ``sharding``: an ``AccelerateResult``; its ``shard_batch`` places
    the rows (this rank's block of each microbatch), with
    ``stacked=True`` when ``steps_per_call`` > 1, and the items are
    ``PlacedBatch``es, which the trainer's own ``shard_batch`` passes
    through. Without it the batch
    moves whole to ``device``. ``device`` defaults to the sharding's,
    else ``cuda``, and a missing card raises: nothing falls back to the
    CPU.

    ``global_rows``: the global batch's row count. Each process feeds
    its own rows, ``global_rows`` over the world's size, and any other
    count raises (a caller feeding the global batch on every rank would
    otherwise train on duplicated rows). 0 skips the check.

    ``steps_per_call``: K > 1 stacks K consecutive batches along a new
    leading axis, one item per ``train_step_multi`` call; a trailing
    group short of K is dropped (fixed shapes only). Leave it at 1 when
    the items feed ``TrainExecutor``, which groups batches itself.

    ``put_fn``: replaces the placement entirely (no arena, no stream).
    ``background=True`` runs the placement on one thread feeding a
    queue of depth ``prefetch``; the thread starts at the first
    iteration and every later ``__iter__`` resumes from it. A failure
    in the thread is raised in the consumer. It refuses a sharding whose
    placement exchanges rows between ranks (several ranks, several
    microbatches). ``close()`` stops the thread and releases the arena.
    """

    def __init__(self, iterable, sharding=None, prefetch: int = 2,
                 global_rows: int = 0, steps_per_call: int = 1,
                 put_fn: Optional[Callable[[Any], Any]] = None,
                 background: bool = False, device: DeviceLike = None):
        if prefetch < 1:
            raise ValueError("prefetch must be >= 1")
        if steps_per_call < 1:
            raise ValueError("steps_per_call must be >= 1")
        if (background and sharding is not None
                and getattr(sharding, "world", 1) > 1
                and sharding.strategy.grad_accum_steps > 1):
            # placement then all-gathers process-local rows: from a pump
            # thread those exchanges would interleave with the step's
            raise ValueError(
                "background placement by a sharding over several ranks "
                "with grad_accum_steps > 1 would exchange rows from the "
                "pump thread; use the foreground mode")
        self._iterable = iterable
        self._sharding = sharding
        self._prefetch = prefetch
        self._global_rows = int(global_rows)
        self._steps_per_call = int(steps_per_call)
        self._put_fn = put_fn
        self._background = background
        self.device: Optional[torch.device] = None
        if device is not None or put_fn is None:
            self.device = resolve_device(
                device if device is not None
                else getattr(sharding, "device", None))
        self._pinned = put_fn is None and self.device.type == "cuda"
        if self._pinned and self.device.index is None:
            # the card the caller's thread is on; the pump thread sets it
            self.device = torch.device("cuda", torch.cuda.current_device())
        self._arena: Optional[_PinnedArena] = (
            _PinnedArena(prefetch + 1) if self._pinned else None)
        self._stream: Optional[torch.cuda.Stream] = None
        # data-plane instruments: the depth gauge pinned at 0 means the
        # producer cannot keep up (input-bound); at `prefetch`, the
        # consumer is the bottleneck (healthy). The wait histograms
        # tell the same story by direction
        reg = get_registry()
        self._g_depth = reg.gauge(
            tm.DATA_PREFETCH_QUEUE_DEPTH,
            help="ready batches in the H2D prefetch queue")
        self._h_producer_wait = reg.histogram(
            tm.DATA_PRODUCER_WAIT_TIME,
            help="producer-side wait per batch (foreground: host time "
                 "producing + issuing the next transfer; background: "
                 "time blocked handing a ready batch to a full queue)")
        self._h_consumer_wait = reg.histogram(
            tm.DATA_CONSUMER_WAIT_TIME,
            help="consumer time blocked on an empty prefetch queue "
                 "(the input-bound direction)")
        # background pump, created once at the first iteration: a
        # second pump over one source iterator would drop and
        # interleave batches
        self._bg_queue: Optional[_queue.Queue] = None
        self._bg_thread: Optional[threading.Thread] = None
        self._bg_done = object()
        self._bg_error: List[BaseException] = []
        self._bg_exhausted = False
        self._stop = threading.Event()

    # -- placement ----------------------------------------------------------

    def _check_rows(self, batch: Dict):
        if not self._global_rows:
            return
        axis = 1 if self._steps_per_call > 1 else 0
        rows = next(iter(batch.values())).shape[axis]
        world = int(getattr(self._sharding, "world", 1))
        expected = self._global_rows // world
        if rows != expected:
            raise ValueError(
                f"each process feeds its PROCESS-LOCAL rows: expected "
                f"{expected} rows/process (global batch "
                f"{self._global_rows} over {world} processes), got {rows}")

    def _place(self, batch: Dict) -> Dict:
        if self._sharding is not None:
            from dlrover_tpu_torch.parallel.accelerate import PlacedBatch

            stacked = self._steps_per_call > 1
            return PlacedBatch(
                self._sharding.shard_batch(batch, stacked=stacked),
                self._sharding, stacked)
        return {k: torch.as_tensor(v).to(self.device, non_blocking=True)
                for k, v in batch.items()}

    def _put(self, batch):
        """-> (item, event): the event marks the end of the item's copy
        (None off the card)."""
        if self._put_fn is not None:
            return self._put_fn(batch), None
        self._check_rows(batch)
        if not self._pinned:
            return self._place(batch), None
        if self._stream is None:
            self._stream = torch.cuda.Stream(device=self.device)
        staged, handles, on_card = {}, [], False
        for key, value in batch.items():
            if isinstance(value, torch.Tensor) and value.is_cuda:
                staged[key], on_card = value, True
                continue
            staged[key], handle = self._arena.stage(key, value)
            handles.append(handle)
        if on_card:
            # a value already on the card was made on the producer's
            # stream: the copy stream reads it after that work
            self._stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(self._stream):
            item = self._place(staged)
            event = torch.cuda.Event()
            event.record(self._stream)
        self._arena.mark(handles, event)
        return item, event

    def _deliver(self, pending):
        item, event = pending
        if event is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(event)
            for t in _tensors(item):
                if t.is_cuda:
                    t.record_stream(stream)
        return item

    def arena_slots(self) -> int:
        """Pinned slots allocated so far (0 off the card)."""
        return self._arena.slot_count() if self._arena is not None else 0

    # -- iteration ----------------------------------------------------------

    def _host_items(self):
        """Raw batches, or K-stacked groups when steps_per_call > 1."""
        if self._steps_per_call == 1:
            yield from self._iterable
            return
        group: List[Any] = []
        for batch in self._iterable:
            group.append(batch)
            if len(group) == self._steps_per_call:
                yield stack_batches(group)
                group = []
        if group:
            logger.warning(
                "dropping %d trailing batches short of steps_per_call=%d "
                "(fixed shapes only)", len(group), self._steps_per_call,
            )

    def __iter__(self):
        if self._background:
            yield from self._background_iter()
            return
        pending = collections.deque()
        it = iter(self._host_items())
        try:
            for _ in range(self._prefetch):
                pending.append(self._put(next(it)))
        except StopIteration:
            pass
        while pending:
            out = pending.popleft()
            t0 = time.monotonic()
            try:
                pending.append(self._put(next(it)))
            except StopIteration:
                pass
            # foreground mode produces in the consumer's thread: this is
            # the consumer's host cost a batch (the copy itself is
            # asynchronous on the card)
            self._h_producer_wait.observe(time.monotonic() - t0)
            self._g_depth.set(len(pending))
            yield self._deliver(out)

    def _pump(self):
        try:
            if self._pinned:
                torch.cuda.set_device(self.device)
            for b in self._host_items():
                if self._stop.is_set():
                    return
                item = self._put(b)
                t0 = time.monotonic()
                while True:
                    try:
                        self._bg_queue.put(item, timeout=0.05)
                        break
                    except _queue.Full:
                        if self._stop.is_set():
                            return
                # time blocked on a full queue: the consumer is slower
                # than the pipeline (the healthy direction)
                self._h_producer_wait.observe(time.monotonic() - t0)
        except BaseException as e:  # surfaced in the consumer
            logger.warning("prefetch pump failed (%s); re-raising in the "
                           "consumer", type(e).__name__)
            self._bg_error.append(e)
        finally:
            while not self._stop.is_set():
                try:
                    self._bg_queue.put(self._bg_done, timeout=0.05)
                    break
                except _queue.Full:
                    pass

    def _background_iter(self):
        if self._bg_queue is None:
            self._bg_queue = _queue.Queue(maxsize=self._prefetch)
            self._bg_thread = threading.Thread(
                target=self._pump, name="device-preloader", daemon=True)
            self._bg_thread.start()
        while not self._bg_exhausted:
            t0 = time.monotonic()
            item = self._bg_queue.get()
            # time blocked on an empty queue: the producer is the
            # bottleneck (the input-bound direction)
            self._h_consumer_wait.observe(time.monotonic() - t0)
            self._g_depth.set(self._bg_queue.qsize())
            if item is self._bg_done:
                self._bg_exhausted = True
                break
            yield self._deliver(item)
        if self._bg_error:
            raise self._bg_error[0]

    def close(self, timeout: float = 10.0):
        """Stop the pump thread (joined within ``timeout``) and release
        the pinned arena and the copy stream."""
        self._stop.set()
        if self._bg_thread is not None:
            deadline = time.monotonic() + timeout
            while self._bg_thread.is_alive() and \
                    time.monotonic() < deadline:
                try:  # unblock a pump waiting on a full queue
                    self._bg_queue.get(timeout=0.05)
                except _queue.Empty:
                    pass
            self._bg_thread.join(max(0.0, deadline - time.monotonic()))
            if self._bg_thread.is_alive():
                raise RuntimeError("the prefetch pump did not stop within "
                                   f"{timeout} s")
        if self._stream is not None:
            self._stream.synchronize()
        self._arena = None
        self._stream = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
