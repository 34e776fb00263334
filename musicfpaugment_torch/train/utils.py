"""Runtime utilities (port of musicfpaugment_tpu/train/utils.py).

Device listing is a CUDA query. The distributed helpers answer from
``torch.distributed`` when a process group is initialised, and as one
process otherwise (multi-process training is not ported yet).
"""

from __future__ import annotations

import os
import shutil
import tempfile
from typing import List

import numpy as np
import torch
import torch.distributed as dist


def set_gpus() -> List[torch.device]:
    """Alias of :func:`set_devices`, the reference's name."""
    return set_devices()


def set_devices() -> List[torch.device]:
    """The CUDA devices of this machine, in index order (empty without
    CUDA)."""
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def is_dist_avail_and_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def get_world_size() -> int:
    return dist.get_world_size() if is_dist_avail_and_initialized() else 1


def get_rank() -> int:
    return dist.get_rank() if is_dist_avail_and_initialized() else 0


def is_main_process() -> bool:
    return get_rank() == 0


def fix_random_seeds(seed: int = 59) -> None:
    """Seed numpy's global generator and torch's (the CPU's and every CUDA
    device's: ``torch.manual_seed`` seeds both), 59 like the reference."""
    np.random.seed(seed)
    torch.manual_seed(seed)


def remove_val_cache(path: str = os.path.join(tempfile.gettempdir(), "validation_set_cache")) -> None:
    """Clear the validation-set cache files."""
    for candidate in [path, path + ".index", path + ".data-00000-of-00001"]:
        if os.path.isdir(candidate):
            shutil.rmtree(candidate, ignore_errors=True)
        elif os.path.exists(candidate):
            os.remove(candidate)
