"""numpy-facing wrappers of the C++ host ops (``src/host_ops.cc``), with
their numpy versions beside them (port of
``dlrover_tpu/native/host_ops.py``).

``use_native=True`` (the default) runs the library's op, and raises
when the library does not build: unlike the reference, which falls back
to numpy when its toolchain is missing, nothing here switches path
quietly. ``use_native=False`` selects the numpy version, the plain
version both are held against.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np

from dlrover_tpu_torch.native import load_library


def _as_ptr(arr: np.ndarray, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def pack_sequences(tokens: np.ndarray, offsets: np.ndarray, max_len: int,
                   pad_id: int = 0,
                   use_native: bool = True) -> Tuple[np.ndarray, np.ndarray]:
    """Ragged [sum(lens)] tokens + [N+1] offsets -> ([N, max_len] ids,
    [N, max_len] mask); long sequences truncate, short ones pad."""
    tokens = np.ascontiguousarray(tokens, np.int32)
    offsets = np.ascontiguousarray(offsets, np.int64)
    n = len(offsets) - 1
    if n < 0 or (n and (offsets[0] < 0 or offsets[-1] > len(tokens)
                        or np.any(np.diff(offsets) < 0))):
        raise ValueError("offsets must rise from 0 to at most "
                         f"len(tokens) = {len(tokens)}")
    ids = np.empty((n, max_len), np.int32)
    mask = np.empty((n, max_len), np.int32)
    if use_native:
        load_library().pack_sequences(
            _as_ptr(tokens, ctypes.c_int32), _as_ptr(offsets, ctypes.c_int64),
            n, max_len, pad_id,
            _as_ptr(ids, ctypes.c_int32), _as_ptr(mask, ctypes.c_int32),
        )
        return ids, mask
    for i in range(n):
        seq = tokens[offsets[i]:offsets[i + 1]][:max_len]
        ids[i, :len(seq)] = seq
        ids[i, len(seq):] = pad_id
        mask[i, :len(seq)] = 1
        mask[i, len(seq):] = 0
    return ids, mask


def shuffle_indices(n: int, seed: int,
                    use_native: bool = True) -> np.ndarray:
    """Deterministic permutation of arange(n) (splitmix64 Fisher-Yates)."""
    indices = np.arange(n, dtype=np.int64)
    if use_native:
        load_library().shuffle_indices(_as_ptr(indices, ctypes.c_int64), n,
                                       ctypes.c_uint64(seed))
        return indices
    state = seed & 0xFFFFFFFFFFFFFFFF

    def next_u64():
        nonlocal state
        state = (state + 0x9E3779B97F4A7C15) & 0xFFFFFFFFFFFFFFFF
        z = state
        z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
        z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
        return z ^ (z >> 31)

    for i in range(n - 1, 0, -1):
        j = next_u64() % (i + 1)
        indices[i], indices[j] = indices[j], indices[i]
    return indices


def shift_labels(ids: np.ndarray, mask: np.ndarray, ignore_id: int = -100,
                 use_native: bool = True) -> np.ndarray:
    """Causal-LM next-token labels; padded positions get ignore_id."""
    ids = np.ascontiguousarray(ids, np.int32)
    mask = np.ascontiguousarray(mask, np.int32)
    if ids.ndim != 2 or mask.shape != ids.shape:
        raise ValueError(f"ids {ids.shape} and mask {mask.shape} must be "
                         "one [rows, seq] shape")
    n, s = ids.shape
    labels = np.empty((n, s), np.int32)
    if use_native:
        load_library().shift_labels(
            _as_ptr(ids, ctypes.c_int32), _as_ptr(mask, ctypes.c_int32),
            n, s, ignore_id, _as_ptr(labels, ctypes.c_int32),
        )
        return labels
    labels[:, :-1] = np.where(mask[:, 1:] == 1, ids[:, 1:], ignore_id)
    labels[:, -1] = ignore_id
    return labels
