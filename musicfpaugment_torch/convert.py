"""Carry state across from the JAX package.

What a JAX run leaves behind is its :class:`HashTable`, its augmentation
banks and its UNet weights. :func:`hash_table_from_arrays` adopts that
table's numpy arrays (the fields of its npz file),
:func:`noise_bank_from_arrays` / :func:`ir_bank_from_arrays` the fields of a
JAX ``NoiseBank`` / ``IRBank`` as numpy arrays, and
:func:`unet_state_dict_from_flax` the Flax UNet's ``params`` and
``batch_stats`` as nested dicts of numpy arrays, all without importing the
JAX package; :func:`unet_state_dict_to_flax` carries a UNet trained here
back the other way. :func:`unet_denoiser` makes of a :class:`UNet` the spectrogram
hook that the analyzer and the matcher take.
"""

from __future__ import annotations

from typing import Callable, Dict, Mapping, Sequence, Tuple

import numpy as np
import torch

from musicfpaugment_torch.afp.audfprint.hash_table import HashTable
from musicfpaugment_torch.augment.banks import IRBank, NoiseBank
from musicfpaugment_torch.device import DeviceLike, resolve_device
from musicfpaugment_torch.models.unet import UNet


def hash_table_from_arrays(
    table: np.ndarray,
    counts: np.ndarray,
    names: Sequence,
    hashesperid: np.ndarray,
    meta: Sequence[int],
) -> HashTable:
    """A port :class:`HashTable` holding copies of a JAX-side table's arrays.
    ``meta`` is [hashbits, depth, maxtimebits, ht_version]; ``None`` or ""
    names mark freed ids."""
    hashbits, depth = int(meta[0]), int(meta[1])
    table = np.array(table, np.uint32)
    if table.shape != (1 << hashbits, depth):
        raise ValueError(f"table shape {table.shape} != (2^{hashbits}, {depth})")
    ht = HashTable.__new__(HashTable)
    ht._rng = np.random.default_rng(0)
    ht.set_arrays(
        table,
        np.array(counts, np.int32),
        ["" if n is None else n for n in names],
        np.array(hashesperid),
        meta,
    )
    return ht


def _tensor(array, dtype, device) -> torch.Tensor:
    return torch.from_numpy(np.array(array, dtype)).to(device)


def noise_bank_from_arrays(
    clips: np.ndarray,
    scene_starts: np.ndarray,
    scene_counts: np.ndarray,
    sample_rate: int,
    device: DeviceLike = None,
) -> NoiseBank:
    """A port :class:`NoiseBank` on ``device`` (``None`` = CUDA) holding
    copies of a JAX-side bank's fields."""
    device = resolve_device(device)
    clips = _tensor(clips, np.float32, device)
    starts = _tensor(scene_starts, np.int32, device)
    counts = _tensor(scene_counts, np.int32, device)
    if clips.ndim != 2 or starts.shape != counts.shape or starts.ndim != 1:
        raise ValueError("clips must be (N, L) and scene_starts, scene_counts (S,)")
    if int(counts.sum()) != clips.shape[0]:
        raise ValueError(f"scene_counts sum to {int(counts.sum())}, not {clips.shape[0]} rows")
    return NoiseBank(clips, starts, counts, int(sample_rate))


def ir_bank_from_arrays(
    irs: np.ndarray, lengths: np.ndarray, sample_rate: int, device: DeviceLike = None
) -> IRBank:
    """A port :class:`IRBank` on ``device`` (``None`` = CUDA) holding copies
    of a JAX-side bank's fields."""
    device = resolve_device(device)
    irs = _tensor(irs, np.float32, device)
    lengths = _tensor(lengths, np.int32, device)
    if irs.ndim != 2 or lengths.shape != (irs.shape[0],):
        raise ValueError("irs must be (N, L) and lengths (N,)")
    return IRBank(irs, lengths, int(sample_rate))


# ------------------------------------------------------------------- UNet


def _flat(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _double_conv_leaves(flax_prefix: str, torch_prefix: str):
    """(flax leaf, collection, state_dict key, layout) of one DoubleConv."""
    for i in (0, 1):
        conv, bn = f"{torch_prefix}conv{i + 1}", f"{torch_prefix}bn{i + 1}"
        yield f"{flax_prefix}Conv_{i}/kernel", "params", f"{conv}.weight", "conv"
        yield f"{flax_prefix}BatchNorm_{i}/scale", "params", f"{bn}.weight", None
        yield f"{flax_prefix}BatchNorm_{i}/bias", "params", f"{bn}.bias", None
        yield f"{flax_prefix}BatchNorm_{i}/mean", "batch_stats", f"{bn}.running_mean", None
        yield f"{flax_prefix}BatchNorm_{i}/var", "batch_stats", f"{bn}.running_var", None


def _unet_leaf_table(bilinear: bool):
    """(flax leaf, collection, state_dict key, layout) of every UNet leaf."""
    table = list(_double_conv_leaves("DoubleConv_0/", "inc."))
    for i in range(4):
        table += _double_conv_leaves(f"Down_{i}/DoubleConv_0/", f"down{i + 1}.conv.")
        table += _double_conv_leaves(f"Up_{i}/DoubleConv_0/", f"up{i + 1}.conv.")
        if not bilinear:
            table.append((f"Up_{i}/ConvTranspose_0/kernel", "params", f"up{i + 1}.up.weight", "convT"))
            table.append((f"Up_{i}/ConvTranspose_0/bias", "params", f"up{i + 1}.up.bias", None))
    table.append(("Conv_0/kernel", "params", "outc.weight", "conv"))
    table.append(("Conv_0/bias", "params", "outc.bias", None))
    return table


def unet_state_dict_from_flax(params: Mapping, batch_stats: Mapping) -> Dict[str, torch.Tensor]:
    """The ``state_dict`` of the port's :class:`UNet` from the Flax UNet's
    ``params`` and ``batch_stats`` (nested dicts of numpy arrays, as
    ``jax.tree_util.tree_map(np.asarray, variables)`` gives them), so that
    both packages run the same weights. ``load_state_dict(strict=True)``
    takes it (``num_batches_tracked`` is set to 0).

    Layouts: a Flax conv kernel (kh, kw, in, out) becomes (out, in, kh, kw).
    A Flax transposed-conv kernel (kh, kw, in, out) becomes (in, out, kh, kw)
    *with both spatial axes flipped*: Flax correlates the dilated input with
    the kernel as it stands, ``ConvTranspose2d`` is the gradient of a
    convolution and flips it.

    ``base``, ``n_channels``, ``n_classes`` and ``bilinear`` are read off the
    leaves (``bilinear`` = no ``ConvTranspose_0``). Raises ``ValueError`` on
    a missing leaf, on a leaf the model has no use for and on a shape that
    does not fit that model."""
    leaves = {"params": _flat(params), "batch_stats": _flat(batch_stats)}
    try:
        first = leaves["params"]["DoubleConv_0/Conv_0/kernel"]
        last = leaves["params"]["Conv_0/kernel"]
    except KeyError as exc:
        raise ValueError(f"Flax UNet params lack the leaf {exc.args[0]}") from None
    bilinear = "Up_0/ConvTranspose_0/kernel" not in leaves["params"]
    if first.ndim != 4 or last.ndim != 4:
        raise ValueError("Flax conv kernels must be (kh, kw, in, out)")
    with torch.device("meta"):
        model = UNet(int(first.shape[2]), int(last.shape[3]), bilinear=bilinear,
                     base=int(first.shape[3]))
    want = {k: tuple(v.shape) for k, v in model.state_dict().items()}

    state = {}
    for leaf, collection, key, layout in _unet_leaf_table(bilinear):
        if leaf not in leaves[collection]:
            raise ValueError(f"Flax UNet {collection} lack the leaf {leaf}")
        a = np.asarray(leaves[collection].pop(leaf), np.float32)
        if layout is not None and a.ndim != 4:
            raise ValueError(f"{leaf}: a kernel must be (kh, kw, in, out), not {a.shape}")
        if layout == "conv":
            a = a.transpose(3, 2, 0, 1)
        elif layout == "convT":
            a = a[::-1, ::-1].transpose(2, 3, 0, 1)
        if tuple(a.shape) != want[key]:
            raise ValueError(
                f"{leaf}: shape {tuple(a.shape)} as {key} does not fit {want[key]} "
                f"(UNet with base={model.base}, bilinear={bilinear})"
            )
        state[key] = torch.from_numpy(np.array(a, order="C"))
    surplus = [f"{c}:{k}" for c in leaves for k in leaves[c]]
    if surplus:
        raise ValueError(f"Flax leaves the UNet has no use for: {sorted(surplus)}")
    for key in want:
        if key.endswith("num_batches_tracked"):
            state[key] = torch.zeros((), dtype=torch.long)
    return state


def unet_state_dict_to_flax(state_dict: Mapping) -> Tuple[Dict, Dict]:
    """The inverse of :func:`unet_state_dict_from_flax`: the Flax UNet's
    ``(params, batch_stats)`` as nested dicts of numpy float32 arrays from
    the ``state_dict`` of the port's :class:`UNet`, so that a model trained
    here runs in the JAX package (``{"params": ..., "batch_stats": ...}``).
    Conv kernels go back to (kh, kw, in, out) and the transposed-conv
    kernels are flipped back. ``num_batches_tracked`` has no Flax leaf and
    is dropped; any other key the table does not name raises
    ``ValueError``."""
    state = {k: v for k, v in state_dict.items() if not k.endswith("num_batches_tracked")}
    bilinear = "up1.up.weight" not in state
    trees: Dict[str, Dict] = {"params": {}, "batch_stats": {}}
    for leaf, collection, key, layout in _unet_leaf_table(bilinear):
        if key not in state:
            raise ValueError(f"the UNet state_dict lacks {key}")
        a = state.pop(key).detach().to("cpu", torch.float32).numpy()
        if layout == "conv":
            a = a.transpose(2, 3, 1, 0)
        elif layout == "convT":
            a = a.transpose(2, 3, 0, 1)[::-1, ::-1]
        node = trees[collection]
        *parents, name = leaf.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[name] = np.array(a, np.float32, order="C")
    if state:
        raise ValueError(f"state_dict keys the Flax UNet has no leaf for: {sorted(state)}")
    return trees["params"], trees["batch_stats"]


def unet_denoiser(model: UNet) -> Callable[[torch.Tensor], torch.Tensor]:
    """The spectrogram hook of ``model``: (B, F, C) normalised magnitudes ->
    (B, F, C) float32, in ``eval()`` mode under ``torch.inference_mode``, on
    the device the model is on. Give it to ``AudfprintPeaks(...,
    denoising=True, denoising_model="unet", spec_denoiser=...)`` or to
    ``DeviceMatcher.match_waveforms(denoiser=...)``."""
    model.eval()

    def hook(sgram: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode():
            return model(sgram).to(torch.float32)

    return hook
