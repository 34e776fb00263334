"""Device selection for the port's entry points, the TF32 switches of
cuDNN and of cuBLAS's float32 matmuls, and cuDNN's engine choice.

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
def cudnn_tf32(allow: bool, benchmark: Optional[bool] = None):
    """cuDNN convolutions with TF32 allowed or not inside the block (cuDNN
    allows it by default); the other cuDNN flags stay as they are, and
    ``benchmark`` too unless it is given (True: engines chosen by timing,
    False: by cuDNN's heuristic). ``torch.backends.cudnn.flags(allow_tf32=...)``
    alone would also switch cuDNN off (its ``enabled`` defaults to
    ``False``) and set ``benchmark`` and ``benchmark_limit`` to its own
    defaults."""
    cudnn = torch.backends.cudnn
    with cudnn.flags(
        enabled=cudnn.enabled, benchmark=cudnn.benchmark if benchmark is None else benchmark,
        benchmark_limit=cudnn.benchmark_limit, deterministic=cudnn.deterministic,
        allow_tf32=allow,
    ):
        yield


# cuDNN engines timed for each new convolution problem under
# ``cudnn_measured``: the fewest that find the fast ones at both shapes it
# was chosen from, on an H100. At the UNet's training step (128 x 257 x 94
# spectrograms) the first candidate alone is the heuristic's FFT tiling (a
# 668 ms step); the fastest of the first 2 ran the step in 331 ms (326-332
# ms for the first 10), and timing them added 3.3 s to the first step
# (36.7 s for the first 10). At the UNet's identify forward (128 x 257 x
# 251 and x 250) the first candidate is FFT tiling too (488 ms a forward);
# the first 2 gave 329 ms (the same for the first 3, 4 and 10), and timing
# them added 3.5 s to the first forward (28.7 s for the first 10).
MEASURED_ENGINES = 2


@contextlib.contextmanager
def cudnn_measured():
    """Strict-float32 cuDNN convolutions (TF32 off) whose engine is chosen
    by timing: the first time the process meets a convolution problem,
    cuDNN times its first ``MEASURED_ENGINES`` candidates and keeps the
    fastest, in place of taking its heuristic's first. TF32 engines are
    filtered out of the timed candidates as out of the heuristic's. Every
    flag is restored on exit.

    cuDNN keeps one plan a problem a process, keyed by the problem, TF32
    and ``deterministic`` but not ``benchmark``: a problem first met
    outside this scope keeps the heuristic's engine inside it, and one
    first met inside keeps the measured engine outside."""
    cudnn = torch.backends.cudnn
    with cudnn.flags(
        enabled=cudnn.enabled, benchmark=True, benchmark_limit=MEASURED_ENGINES,
        deterministic=cudnn.deterministic, allow_tf32=False,
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
