"""Device selection for the port's entry points.

The port runs on the card. The CPU is a device a caller asks for by name
(the tests do, with ``device="cpu"``), never a silent fallback: a
measurement or a run that lands on the CPU by accident would report CPU
numbers under a GPU's name.
"""
from __future__ import annotations

import contextlib
from typing import Iterator, Optional, Union

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


@contextlib.contextmanager
def exact_fp32() -> Iterator[None]:
    """Full fp32 and cuDNN's deterministic algorithms inside the scope,
    whatever the caller set; the caller's flags come back on exit.

    TF32 off for convolutions and matmuls (cuDNN's own default is TF32
    convolutions, about three decimal digits), cuDNN on with benchmarking
    off and its deterministic algorithms (a default algorithm may accumulate
    in a varying order, so two runs would not be bit-equal). The fleet
    engine runs every round in this scope: its numbers are the fp32
    reference's, and a resumed run equals the unsegmented one bit for bit.
    """
    matmul = torch.backends.cuda.matmul
    matmul_tf32 = matmul.allow_tf32
    try:
        matmul.allow_tf32 = False
        with torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=True,
                                        allow_tf32=False):
            yield
    finally:
        matmul.allow_tf32 = matmul_tf32
