"""Host batches for the fused multi-step call (the part of
``dlrover_tpu/trainer/data.py`` the trainer runs: ``stack_batches``)."""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch


def stack_batches(batches: List[Dict]) -> Dict:
    """Stack K host batches (dicts of numpy arrays or tensors) along a
    new leading axis, key by key: the input of ``accelerate``'s
    ``train_step_multi``."""
    if not batches:
        raise ValueError("stack_batches needs at least one batch")
    out = {}
    for key in batches[0]:
        values = [b[key] for b in batches]
        if isinstance(values[0], torch.Tensor):
            out[key] = torch.stack(values)
        else:
            out[key] = np.stack([np.asarray(v) for v in values])
    return out
