"""Device resolution for the port's entry points.

The port never falls back to the CPU by itself: an entry point runs on
``cuda`` unless the caller asks for ``cpu``, and a request for ``cuda`` on a
host without a card raises.
"""
from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``device`` as a :class:`torch.device`; ``None`` means ``"cuda"``.

    Raises ``RuntimeError`` when CUDA is asked for (explicitly or by
    default) and ``torch.cuda.is_available()`` is false.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA device requested but torch.cuda.is_available() is false; "
            "pass device='cpu' to run the plain PyTorch path")
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"unsupported device {dev}; expected cuda, cpu or "
                         f"meta (shapes only: the dry run)")
    return dev
