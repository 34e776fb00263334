"""Flax's dropout with JAX's draws: the UNet's five dropout sites.

Flax's ``nn.Dropout(rate)`` at call ``i`` of the UNet (``Dropout_i``) keeps
an element where ``bernoulli(fold(k_drop, "Dropout_i", 1), 1 - rate,
NHWC shape)`` is true and writes ``x / (1 - rate)`` there (the divisor in the
activation's type), else 0. :class:`FlaxDropout` does the same on the
port's NCHW activations: element (b, c, h, w) takes the counter of its NHWC
index ``((b H + h) W + w) C + c``, plus ``batch_offset * H W C`` on a rank's
slice of a global batch whose first example is ``batch_offset``, so the
ranks together draw the JAX trainer's global mask.

:func:`dropout` is :func:`dropout_plain` on every device: the reference
takes no kernel.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from portbench.ref.core import prng


def _keep(rate: float):
    """(the float32 keep probability of the test, the Python value)."""
    keep = 1.0 - float(rate)
    return float(torch.tensor(keep, dtype=torch.float32)), keep


def _check(x: torch.Tensor, rate: float) -> None:
    if x.dim() != 4:
        raise ValueError(f"dropout takes (B, C, H, W) activations, not {tuple(x.shape)}")
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"rate must be in [0, 1), not {rate}")


def dropout_plain(x: torch.Tensor, key: torch.Tensor, rate: float, batch_offset: int = 0) -> torch.Tensor:
    """The plain version: the mask from ``prng.bernoulli`` over the NHWC
    shape (from the slice's first counter), permuted to NCHW; the kept
    elements divided by the keep probability in ``x``'s type. Differentiable
    by autograd."""
    _check(x, rate)
    B, C, H, W = x.shape
    keep32, keep = _keep(rate)
    mask = prng.bernoulli(prng.as_key(key, x.device), keep32, (B, H, W, C),
                          offset=int(batch_offset) * H * W * C).permute(0, 3, 1, 2)
    divisor = torch.tensor(keep, dtype=x.dtype, device=x.device)
    return torch.where(mask, x / divisor, torch.zeros((), dtype=x.dtype, device=x.device))


def dropout(x: torch.Tensor, key: torch.Tensor, rate: float, batch_offset: int = 0) -> torch.Tensor:
    """Flax's dropout of a (B, C, H, W) activation under the site's key:
    the kernel on CUDA, the plain version on the CPU."""
    return dropout_plain(x, key, rate, batch_offset)


class FlaxDropout(nn.Module):
    """``flax.linen.Dropout(rate)`` named ``Dropout_{index}``: in training
    at ``rate > 0`` it needs the forward pass's dropout key (it raises
    without one, and never draws from torch's generator); in evaluation, or
    at rate 0, it is the identity."""

    def __init__(self, rate: float, index: int) -> None:
        super().__init__()
        self.rate, self.index = float(rate), int(index)

    def extra_repr(self) -> str:
        return f"rate={self.rate}, name=Dropout_{self.index}"

    def forward(self, x: torch.Tensor, key: Optional[torch.Tensor] = None,
                batch_offset: int = 0) -> torch.Tensor:
        if not self.training or self.rate == 0.0:
            return x
        if key is None:
            raise ValueError(
                f"Dropout_{self.index}: a training forward at rate {self.rate} needs the "
                "dropout key (UNet(..., dropout_key=...); the Trainer passes its step's)")
        return dropout(x, prng.flax_fold(key, f"Dropout_{self.index}", 1), self.rate, batch_offset)


__all__ = ["FlaxDropout", "dropout", "dropout_plain"]
