"""Fresh weights as the JAX package makes them: Flax's ``model.init``.

The JAX package starts every model from ``model.init(PRNGKey(0), ...)``:
each parameter is drawn by its module's default initialiser under the key
that Flax folds from the module's path and the parameter's place in it
(``prng.flax_fold``). :func:`flax_init` builds that parameter tree leaf by
leaf for a port :class:`UNet` or :class:`Demucs` and loads it through the
converters in ``convert.py``, so a fresh port model holds the JAX package's
starting weights (to the last ulp or two: the samplers' ``erf_inv`` and
the LSTM's QR round as their device does, see ``core/prng.py``).

Flax's defaults: ``Conv``, ``ConvTranspose`` and ``Dense`` kernels are
``lecun_normal`` (a normal truncated at two deviations, scaled to unit
variance over the fan-in) and their biases zero; ``BatchNorm`` has scale 1,
bias 0, mean 0 and variance 1; an ``OptimizedLSTMCell`` has ``lecun_normal``
input kernels (``ii`` .. ``io``), ``orthogonal`` recurrent kernels
(``hi`` .. ``ho``) and zero biases. Every leaf is drawn on the model's
device. The JAX trainer rescales a fresh Demucs after this
(``rescale_params``); :func:`flax_init` does not.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np
import torch
from torch import nn

from musicfpaugment_torch.core import prng
from musicfpaugment_torch.models.demucs import Demucs
from musicfpaugment_torch.models.unet import UNet

# the standard deviation of a unit normal truncated to (-2, 2)
_TRUNCATED_STD = np.float32(0.87962566103423978)


def lecun_normal(key: torch.Tensor, shape: Tuple[int, ...]) -> torch.Tensor:
    """``jax.nn.initializers.lecun_normal()`` of a kernel in Flax's layout
    (the input features second to last, the outputs last) in float32."""
    fan_in = math.prod(shape[:-1])
    stddev = np.sqrt(np.float32(1.0 / fan_in)) / _TRUNCATED_STD
    return prng.truncated_normal(key, -2.0, 2.0, shape) * torch.tensor(
        stddev, dtype=torch.float32, device=key.device)


def _leaf(root: torch.Tensor, path: str, shape: Tuple[int, ...]) -> torch.Tensor:
    """The initial value of the Flax leaf ``path`` ("A_0/B_1/kernel")."""
    *modules, name = path.split("/")
    device = root.device
    if name in ("bias", "mean"):
        return torch.zeros(shape, dtype=torch.float32, device=device)
    if name in ("scale", "var"):
        return torch.ones(shape, dtype=torch.float32, device=device)
    if name != "kernel":
        raise ValueError(f"no Flax initialiser for the leaf {path}")
    # the kernel is the first parameter of its module: counter 1
    key = prng.flax_fold(root, *modules, 1)
    if modules[-1] in ("hi", "hf", "hg", "ho"):  # an LSTM cell's recurrent kernel
        if len(shape) != 2:
            raise ValueError(f"{path}: a recurrent kernel is 2-D, not {shape}")
        return prng.orthogonal(key, *shape)
    return lecun_normal(key, shape)


def _draw(tree: Dict, root: torch.Tensor, prefix: str = "") -> Dict:
    """The tree's shapes -> nested dicts of float32 numpy arrays, each leaf
    drawn on ``root``'s device."""
    out = {}
    for name, leaf in tree.items():
        if isinstance(leaf, dict):
            out[name] = _draw(leaf, root, f"{prefix}{name}/")
        else:
            out[name] = _leaf(root, prefix + name, tuple(leaf.shape)).cpu().numpy()
    return out


@torch.no_grad()
def flax_init(model: nn.Module, seed: int = 0) -> nn.Module:
    """Load into ``model`` (a port :class:`UNet` or :class:`Demucs`, in
    place) the parameters and running statistics that the JAX package's
    ``model.init(PRNGKey(seed), ...)`` gives the same model. Returns it."""
    from musicfpaugment_torch import convert

    try:
        device = next(model.parameters()).device
    except StopIteration:
        raise ValueError("the model has no parameters") from None
    root = prng.key(seed, device)
    if isinstance(model, UNet):
        params, stats = convert.unet_state_dict_to_flax(model.state_dict())
        state = convert.unet_state_dict_from_flax(_draw(params, root), _draw(stats, root))
    elif isinstance(model, Demucs):
        state = convert.demucs_state_dict_from_flax(
            _draw(convert.demucs_state_dict_to_flax(model.state_dict()), root))
    else:
        raise TypeError(f"flax_init takes a UNet or a Demucs, not {type(model).__name__}")
    model.load_state_dict(state, strict=True)
    return model


__all__ = ["flax_init", "lecun_normal"]
