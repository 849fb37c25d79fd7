"""Binary tensor framing (the port's copy of
``dlrover_tpu/common/tensor_codec.py``, byte for byte the same frames,
so a batch packed by either package is read by the other).

The shm data ring (``native/shm_ring.py``) moves dicts of numpy arrays
as raw bytes in this layout::

    [4-byte big-endian header length][header JSON][buf0][buf1]...

Header::

    {"meta": {...}, "tensors": [{"name","dtype","shape","nbytes"}, ...]}

No base64, no copies beyond the single ``b"".join`` on pack; unpack is
zero-copy ``frombuffer`` views unless ``copy=True`` (required when the
backing buffer is a reused shm slot).
"""

from __future__ import annotations

import json
import struct
from typing import Any, Dict, Tuple

import numpy as np

_LEN = struct.Struct(">I")


def pack_frame(meta: Dict[str, Any],
               tensors: Dict[str, np.ndarray] | None = None) -> bytes:
    tensors = tensors or {}
    manifest = []
    bufs = []
    for name in sorted(tensors):
        arr = np.ascontiguousarray(tensors[name])
        manifest.append({
            "name": name,
            "dtype": arr.dtype.str,
            "shape": list(arr.shape),
            "nbytes": arr.nbytes,
        })
        bufs.append(arr.tobytes())
    header = json.dumps({"meta": meta, "tensors": manifest}).encode()
    return b"".join([_LEN.pack(len(header)), header] + bufs)


def unpack_frame(frame, copy: bool = False
                 ) -> Tuple[Dict[str, Any], Dict[str, np.ndarray]]:
    """``frame``: bytes or memoryview. ``copy=True`` materializes each
    array (use when the buffer will be overwritten, e.g. shm ring slots)."""
    view = memoryview(frame)
    (hlen,) = _LEN.unpack_from(view, 0)
    header = json.loads(bytes(view[4:4 + hlen]))
    tensors: Dict[str, np.ndarray] = {}
    offset = 4 + hlen
    for entry in header["tensors"]:
        n = entry["nbytes"]
        arr = np.frombuffer(
            view[offset:offset + n], dtype=np.dtype(entry["dtype"])
        ).reshape(entry["shape"])
        tensors[entry["name"]] = arr.copy() if copy else arr
        offset += n
    return header["meta"], tensors
