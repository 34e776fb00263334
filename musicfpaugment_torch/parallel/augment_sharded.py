"""``AugmentFP`` split over a device mesh (port of
musicfpaugment_tpu/parallel/augment_sharded.py).

The batch is split over the ``data`` axis and each device runs the chain on
its slice; the banks are put once on each distinct device. The draws are
made once for the whole batch on the host and each device applies its
slice of them, so the shards together are ``AugmentFP.apply`` of the whole
batch on those draws.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from musicfpaugment_torch.augment.pipeline import AugmentFP
from musicfpaugment_torch.augment.transforms import Draws
from musicfpaugment_torch.device import DeviceLike
from musicfpaugment_torch.parallel.mesh import distinct, make_mesh, shard_bounds


def shard_draws(draws: Sequence[Draws], start: int, stop: int) -> List[Draws]:
    """Examples ``start:stop`` of a batch's per-stage draws."""
    return [{k: v[start:stop] for k, v in d.items()} for d in draws]


class ShardedAugmenter:
    """Data-parallel :class:`AugmentFP` over ``mesh`` (default: every CUDA
    device). ``batch_augment`` takes a batch whose size the mesh size
    divides and returns one output tensor per mesh position, on its
    device."""

    def __init__(self, augmenter: AugmentFP, mesh: Optional[Sequence[DeviceLike]] = None):
        if augmenter.batch_quantile_clipping:
            raise ValueError("batch quantile clipping couples a batch's examples: it cannot be split")
        self.augmenter = augmenter
        self.mesh = make_mesh(devices=mesh)
        self._on = {d: augmenter.to(d) for d in distinct(self.mesh)}

    @property
    def num_devices(self) -> int:
        return len(self.mesh)

    def batch_augment(self, waveforms, key: Optional[torch.Tensor] = None) -> List[torch.Tensor]:
        """(B, channels, time) or (B, time) -> the augmented slice of each
        mesh position, from one set of draws for the whole batch under
        ``key`` (default: the next key of the augmenter's stream)."""
        waveforms = torch.as_tensor(waveforms, dtype=torch.float32)
        bounds = shard_bounds(waveforms.shape[0], self.mesh)
        draws = self.augmenter.draw(waveforms.shape[0], waveforms.shape[-1], key)
        return [
            self._on[d].apply(waveforms[lo:hi].to(d), shard_draws(draws, lo, hi))
            for (lo, hi), d in zip(bounds, self.mesh)
        ]
