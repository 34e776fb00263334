"""Device selection for the port's entry points, and the TF32 switches of
cuDNN and of cuBLAS's float32 matmuls.

Entry points run on the card unless the caller asks for the CPU: ``None``
means ``"cuda"``, and asking for CUDA where there is none raises instead of
falling back.
"""

from __future__ import annotations

import contextlib
from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> ``cuda``; raises if CUDA is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU"
        )
    return dev


@contextlib.contextmanager
def cudnn_tf32(allow: bool):
    """cuDNN convolutions with TF32 allowed or not inside the block (cuDNN
    allows it by default); the other cuDNN flags stay as they are.
    ``torch.backends.cudnn.flags(allow_tf32=...)`` alone would also switch
    cuDNN off: its ``enabled`` defaults to ``False``."""
    cudnn = torch.backends.cudnn
    with cudnn.flags(
        enabled=cudnn.enabled, benchmark=cudnn.benchmark,
        deterministic=cudnn.deterministic, allow_tf32=allow,
    ):
        yield


@contextlib.contextmanager
def matmul_tf32(allow: bool):
    """float32 matmuls (cuBLAS, ``torch.backends.cuda.matmul.allow_tf32``)
    with TF32 allowed or not inside the block, restored on exit.
    :func:`cudnn_tf32` does not touch this switch."""
    matmul = torch.backends.cuda.matmul
    before = matmul.allow_tf32
    matmul.allow_tf32 = allow
    try:
        yield
    finally:
        matmul.allow_tf32 = before
