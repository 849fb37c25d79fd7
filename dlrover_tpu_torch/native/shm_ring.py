"""Python face of the C++ shared-memory batch ring (port of
``dlrover_tpu/native/shm_ring.py``).

Shared-memory batch transport between coworker preprocessing processes
and trainers. Batches are dicts of numpy arrays, framed by
``common.tensor_codec`` (a JSON manifest and the raw array bytes, no
pickle on the hot path). Segment and frame are the reference's, so a
ring either package creates is attached and read by the other.
"""

from __future__ import annotations

import ctypes
import errno
import threading
from typing import Dict

import numpy as np

from dlrover_tpu_torch.common import tensor_codec
from dlrover_tpu_torch.native import load_library


class RingClosed(Exception):
    """Producer closed the stream and every slot has been drained."""


class RingTimeout(Exception):
    pass


def _pack_batch(batch: Dict[str, np.ndarray]) -> bytes:
    """Shared framework codec (``common.tensor_codec``): json manifest +
    raw array bytes, no pickle on the hot path."""
    return tensor_codec.pack_frame({}, batch)


def _unpack_batch(buf: memoryview) -> Dict[str, np.ndarray]:
    # copy=True: the arrays must own their memory — the slot gets reused
    _meta, out = tensor_codec.unpack_frame(buf, copy=True)
    return out


class ShmBatchRing:
    """Create with ``owner=True`` in one process, ``attach`` elsewhere."""

    def __init__(self, name: str, slot_bytes: int = 1 << 22,
                 n_slots: int = 8, owner: bool = True):
        self._lib = load_library()
        self.name = name
        self.owner = owner
        if owner:
            handle = self._lib.shm_ring_create(
                name.encode(), slot_bytes, n_slots
            )
        else:
            handle = self._lib.shm_ring_attach(name.encode())
        if not handle:
            raise OSError(f"shm ring {name!r} unavailable "
                          f"(owner={owner})")
        self._handle = ctypes.c_void_p(handle)
        # the control block is authoritative (an attacher's guess at the
        # creator's slot size would livelock pop on a bigger payload)
        self._slot_bytes = int(self._lib.shm_ring_slot_size(self._handle))
        self._scratch = (ctypes.c_uint8 * self._slot_bytes)()
        self._pop_lock = threading.Lock()  # _scratch is shared per handle

    @classmethod
    def attach(cls, name: str, slot_bytes: int = 0) -> "ShmBatchRing":
        """slot size is read from the segment; the arg is ignored and kept
        for signature compatibility."""
        del slot_bytes
        return cls(name, owner=False)

    def put(self, batch: Dict[str, np.ndarray],
            timeout: float = 60.0) -> None:
        blob = _pack_batch(batch)
        if len(blob) > self._slot_bytes:
            raise ValueError(
                f"batch of {len(blob)} bytes exceeds slot size "
                f"{self._slot_bytes}"
            )
        # borrow the bytes object directly (the C side memcpys, never
        # mutates) — avoids a second full copy of the payload
        buf = ctypes.cast(ctypes.c_char_p(blob),
                          ctypes.POINTER(ctypes.c_uint8))
        rc = self._lib.shm_ring_push(
            self._handle, buf, len(blob), int(timeout * 1000)
        )
        if rc == errno.ETIMEDOUT:
            raise RingTimeout(f"put timed out after {timeout}s")
        if rc == errno.EPIPE:
            raise RingClosed("ring closed")
        if rc:
            raise OSError(f"shm_ring_push failed: errno {rc}")

    def get(self, timeout: float = 60.0) -> Dict[str, np.ndarray]:
        with self._pop_lock:
            n = self._lib.shm_ring_pop(
                self._handle, self._scratch, self._slot_bytes,
                int(timeout * 1000),
            )
            if n == -errno.ETIMEDOUT:
                raise RingTimeout(f"get timed out after {timeout}s")
            if n == -errno.EPIPE:
                raise RingClosed("ring closed and drained")
            if n < 0:
                raise OSError(f"shm_ring_pop failed: errno {-n}")
            return _unpack_batch(memoryview(self._scratch)[:n])

    def qsize(self) -> int:
        return max(0, self._lib.shm_ring_size(self._handle))

    def close(self) -> None:
        """Signal end-of-stream (consumers drain, then see RingClosed)."""
        if self._handle:
            self._lib.shm_ring_close(self._handle)

    def free(self) -> None:
        """Unmap (and unlink, if owner) the segment."""
        if self._handle:
            self._lib.shm_ring_free(self._handle)
            self._handle = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        self.free()


# the end-of-stream sentinel a coworker puts after its last batch: the
# consumer closes the ring once every producer has sent one (closing at
# one producer's end would cut off its slower siblings)
DONE_KEY = "__shm_producer_done__"


def producer_main(ring_name: str, produce_fn, worker_rank: int,
                  num_workers: int):
    """A coworker process's loop: ``produce_fn(worker_rank,
    num_workers)`` yields dicts of numpy arrays into the ring. It lives
    here, beside the ring, so a spawned coworker imports numpy and
    ctypes, and no torch, before it runs ``produce_fn``."""
    ring = ShmBatchRing.attach(ring_name)
    try:
        for batch in produce_fn(worker_rank, num_workers):
            ring.put(batch)
        ring.put({DONE_KEY: np.array([worker_rank], np.int32)})
    except (RingClosed, RingTimeout):
        pass  # the consumer went away
    finally:
        ring.free()
