"""Transform composition (port of musicfpaugment_tpu/augment/compose.py).

``Compose.draw`` splits one key per transform, as the JAX package's
``Compose.apply`` does, and makes each transform's draws under its key;
``Compose.apply`` threads the batch through the transforms with those
draws. SomeOf/OneOf pick *which transforms run* per call on the host, with
python's ``random``, as the JAX package does.
"""

from __future__ import annotations

import random as _pyrandom
from typing import List, Optional, Sequence, Tuple, Union

import torch

from portbench.ref.augment.banks import IRBank, NoiseBank
from portbench.ref.augment.transforms import BaseWaveformTransform, Draws
from portbench.ref.core import prng


class BaseCompose:
    def __init__(
        self,
        transforms: Sequence[BaseWaveformTransform],
        shuffle: bool = False,
        p: float = 1.0,
    ):
        self.p = p
        self.shuffle = shuffle
        self.transforms = list(transforms)

    def __len__(self) -> int:
        return len(self.transforms)

    def _run(self, key, indexes, samples, sample_rate, noise_bank, ir_bank):
        """Draw and apply the transforms at ``indexes``, in that order, one
        key split from ``key`` each."""
        keys = prng.split(prng.as_key(key), max(len(indexes), 1))
        for k, i in zip(keys.unbind(-2), indexes):
            samples = self.transforms[i](
                k, samples, sample_rate, noise_bank=noise_bank, ir_bank=ir_bank
            )
        return samples


class Compose(BaseCompose):
    """Sequential application."""

    def draw(
        self,
        key: torch.Tensor,
        batch: int,
        num_samples: int,
        sample_rate: Optional[int] = None,
        noise_bank: Optional[NoiseBank] = None,
        ir_bank: Optional[IRBank] = None,
    ) -> List[Draws]:
        """One draws dict per transform, in the transforms' order, each
        under its key of ``split(key, len(self))`` (one key, or one per
        example)."""
        keys = prng.split(prng.as_key(key), len(self.transforms))
        return [
            t.draw(k, batch, num_samples, sample_rate, noise_bank=noise_bank, ir_bank=ir_bank)
            for t, k in zip(self.transforms, keys.unbind(-2))
        ]

    def apply(
        self,
        samples: torch.Tensor,
        draws: Sequence[Draws],
        sample_rate: Optional[int] = None,
        noise_bank: Optional[NoiseBank] = None,
        ir_bank: Optional[IRBank] = None,
    ) -> torch.Tensor:
        for tfm, d in zip(self.transforms, draws):
            samples = tfm.apply(
                samples, d, sample_rate, noise_bank=noise_bank, ir_bank=ir_bank
            )
        return samples

    def __call__(self, key, samples, sample_rate=None, noise_bank=None, ir_bank=None):
        order = list(range(len(self.transforms)))
        if self.shuffle:
            _pyrandom.shuffle(order)  # host-level
        return self._run(key, order, samples, sample_rate, noise_bank, ir_bank)


class SomeOf(BaseCompose):
    """Randomly pick and apply a subset of transforms."""

    def __init__(
        self,
        num_transforms: Union[int, Tuple[int, Optional[int]]],
        transforms: Sequence[BaseWaveformTransform],
        p: float = 1.0,
    ):
        super().__init__(transforms=transforms, p=p)
        self.all_transforms_indexes = list(range(len(self.transforms)))
        if isinstance(num_transforms, tuple):
            self.min_num_transforms = num_transforms[0]
            self.max_num_transforms = (
                num_transforms[1] if num_transforms[1] else len(transforms)
            )
        else:
            self.min_num_transforms = self.max_num_transforms = num_transforms
        assert self.min_num_transforms >= 1, "min_num_transforms must be >= 1"
        assert self.min_num_transforms <= len(transforms)
        assert self.max_num_transforms <= len(transforms)
        self.transform_indexes: List[int] = []

    def randomize_parameters(self) -> None:
        n = _pyrandom.randint(self.min_num_transforms, self.max_num_transforms)
        self.transform_indexes = sorted(
            _pyrandom.sample(self.all_transforms_indexes, n)
        )

    def __call__(self, key, samples, sample_rate=None, noise_bank=None, ir_bank=None):
        if _pyrandom.random() < self.p:
            self.randomize_parameters()
            samples = self._run(
                key, self.transform_indexes, samples, sample_rate, noise_bank, ir_bank
            )
        return samples


class OneOf(SomeOf):
    """Randomly pick one transform."""

    def __init__(self, transforms: Sequence[BaseWaveformTransform], p: float = 1.0):
        super().__init__(num_transforms=1, transforms=transforms, p=p)
