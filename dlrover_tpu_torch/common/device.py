"""Where the port runs: ``cuda`` unless the caller says otherwise.

An entry point given no ``device`` runs on the GPU, and raises when
there is none: nothing falls back to the CPU quietly. The tests pass
``device="cpu"``.
"""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on "
            "the CPU"
        )
    return dev

