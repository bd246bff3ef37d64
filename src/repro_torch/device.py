"""Device selection for the port's entry points.

The port runs on the card. The CPU is a device a caller asks for by name
(the tests do, with ``device="cpu"``), never a silent fallback: a
measurement or a run that lands on the CPU by accident would report CPU
numbers under a GPU's name.
"""
from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``None`` -> ``cuda`` (raises without a CUDA device); anything else
    is taken as given."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch: no CUDA device was found; pass device=\"cpu\" to "
            "run on the CPU"
        )
    return torch.device("cuda")
