"""The benchmark's inputs, made by the frozen code of ``portbench/ref``: the
corpus, crops of it, the banks, the degraded query pool and the models'
weights. What a traffic mix holds fixed (its ``content_seed``: the identify
cells' corpus and pool, the banks) is the same on every run, so that every
seed does the same work; the rest comes from the run's seed. The same seed
gives the same inputs, and the program and the reference are handed the
same."""

from __future__ import annotations

import contextlib
import functools
import os
from typing import Dict, Sequence, Tuple
from unittest import mock

import numpy as np
import torch

SYNTH_BLOCK = 128  # tracks a call of the corpus generator makes


def tracks(seed: int, indices: Sequence[int], num_samples: int, sample_rate: int,
           device: str) -> torch.Tensor:
    """(len(indices), num_samples) tracks on ``device``; track ``i`` is a
    pure function of (seed, i)."""
    from portbench.ref.data.synthetic import synth_tracks_device

    indices = list(indices)
    parts = [synth_tracks_device(seed, indices[s : s + SYNTH_BLOCK], num_samples,
                                 sample_rate, device=device)
             for s in range(0, len(indices), SYNTH_BLOCK)]
    return torch.cat(parts) if len(parts) > 1 else parts[0]


def crop_plan(seed: int, n: int, n_tracks: int, track_samples: int,
              crop_samples: int) -> Tuple[np.ndarray, np.ndarray]:
    """(track ids, offsets) of ``n`` crops drawn from the seed, no pair
    twice."""
    rng = np.random.default_rng(seed)
    span = track_samples - crop_samples + 1
    seen, ids, offs = set(), [], []
    while len(ids) < n:
        t, o = int(rng.integers(n_tracks)), int(rng.integers(span))
        if (t, o) not in seen:
            seen.add((t, o))
            ids.append(t)
            offs.append(o)
    return np.asarray(ids, np.int64), np.asarray(offs, np.int64)


def crops_from(block: torch.Tensor, block_ids: np.ndarray, ids: np.ndarray, offs: np.ndarray,
               crop_samples: int, out: torch.Tensor) -> None:
    """Write into ``out`` the crops whose track lies in ``block``, whose rows
    are the tracks ``block_ids`` (sorted)."""
    sel = np.nonzero(np.isin(ids, block_ids))[0]
    if sel.size == 0:
        return
    rows = torch.as_tensor(np.searchsorted(block_ids, ids[sel]), device=block.device)
    starts = torch.as_tensor(offs[sel], device=block.device)
    cols = starts[:, None] + torch.arange(crop_samples, device=block.device)[None, :]
    out[torch.as_tensor(sel, device=out.device)] = block[rows[:, None], cols]


def banks(seed: int, sample_rate: int, device: str, **kwargs):
    """``dcase_shaped_banks`` of the frozen augmenter (noise and impulse
    responses), at its defaults unless ``kwargs`` say otherwise; made once
    in a checkout and kept (``harness.cached``)."""
    from portbench import harness as H
    from portbench.ref.augment.banks import IRBank, NoiseBank
    from portbench.ref.augment.pipeline import dcase_shaped_banks

    def build():
        noise, irs = dcase_shaped_banks(sample_rate, seed=seed, device=device, **kwargs)
        return {"clips": noise.clips, "scene_starts": noise.scene_starts,
                "scene_counts": noise.scene_counts, "irs": irs.irs, "lengths": irs.lengths}

    d = H.cached("banks", {"seed": seed, "sample_rate": sample_rate, **kwargs}, build, device)
    return (NoiseBank(d["clips"], d["scene_starts"], d["scene_counts"], sample_rate),
            IRBank(d["irs"], d["lengths"], sample_rate))


CONTENT_PARTS = ("corpus", "queries", "banks", "augment")


def content_seeds(traffic: dict) -> Dict[str, int]:
    """The seeds of what a traffic mix holds fixed whatever the run's seed:
    the corpus, the queries' crops, the banks and the degradation."""
    from portbench import harness as H

    return H.sub_seeds(traffic["content_seed"], CONTENT_PARTS)


def query_pool(config: dict, traffic: dict, device: str) -> Tuple[torch.Tensor, np.ndarray]:
    """(the pool of degraded queries (N, T) on ``device``, the track of
    each): ``traffic["pool"]`` crops of the corpus's tracks under the
    traffic's condition, a pure function of the traffic's content seed,
    made once in a checkout and kept (``harness.cached``)."""
    from portbench import harness as H

    content = content_seeds(traffic)
    sr = config["audfprint"]["samplerate"]
    track_len = config["track_seconds"] * sr
    q_len = config["query_seconds"] * sr
    n = traffic["pool"]
    ids, offs = crop_plan(content["queries"], n, config["tracks"], track_len, q_len)
    cond = H.read_json(os.path.join("portbench", "traffic", "conditions",
                                    traffic["condition"] + ".json"))
    bank_args = traffic.get("banks", {})

    def build():
        clean = torch.empty(n, q_len, device=device)
        uniq = np.unique(ids)
        for s in range(0, len(uniq), 1024):
            part = uniq[s : s + 1024]
            crops_from(tracks(content["corpus"], part.tolist(), track_len, sr, device), part,
                       ids, offs, q_len, clean)
        noise, irs = banks(content["banks"], sr, device, **bank_args)
        return {"pool": degrade(clean, noise, irs, cond, content["augment"], sr,
                                traffic["augment_batch"])}

    params = {"content": content, "tracks": config["tracks"], "track_len": track_len,
              "q_len": q_len, "sample_rate": sr, "pool": n, "condition": cond,
              "banks": bank_args, "augment_batch": traffic["augment_batch"]}
    return H.cached("pool", params, build, device)["pool"], ids


def degrade(clean: torch.Tensor, noise_bank, ir_bank, parameters: dict, seed: int,
            sample_rate: int, batch: int) -> torch.Tensor:
    """The frozen augmenter over ``clean`` (N, T), example ``i`` under
    ``fold_in(PRNGKey(seed), i)`` whatever the batch."""
    from portbench.ref.augment.pipeline import AugmentFP

    aug = AugmentFP(noise_bank, sample_rate, parameters=parameters,
                    impulse_response_dir=ir_bank, device=clean.device)
    aug.freeze_parameters(seed)
    out = torch.empty_like(clean)
    for s in range(0, clean.shape[0], batch):
        e = min(s + batch, clean.shape[0])
        out[s:e] = aug.batch_augment_indexed(clean[s:e], range(s, e))
    return out


# ------------------------------------------------------------------ models

def kind(config: dict):
    """The module of the configuration's denoiser kind, ``kinds/<model>.py``:
    the program's and the reference's modules, the identify cells' weight
    rule, the hook's domain and arm, the FLOPs of a batch, the TF32 control
    and the CPU tests' sizes. Everything that depends on the kind is there."""
    return _kind_module(str(config["model"]))


@functools.lru_cache(maxsize=None)
def _kind_module(name: str):
    from portbench import harness as H

    path = os.path.join(H.BENCH_DIR, "kinds", name + ".py")
    if not os.path.isfile(path):
        raise SystemExit(f"portbench: model {name!r} has no kind file "
                         f"{os.path.relpath(path, H.REPO)}")
    return H.load_file_module(path, "portbench_kind_" + name.replace(".", "_").replace("-", "_"))


def reference_model(config: dict, device="meta") -> torch.nn.Module:
    """The configuration's model from the frozen plain modules."""
    with torch.device(device):
        return kind(config).reference_model(dict(config["model_args"]))


def program_model(config: dict) -> torch.nn.Module:
    """The configuration's model from the program (on the CPU)."""
    return kind(config).program_model(dict(config["model_args"]))


def _kinds(model: torch.nn.Module) -> Dict[str, str]:
    """State key -> the kind of leaf it is, from the module that holds it."""
    from torch import nn

    kinds = {}
    for mname, mod in model.named_modules():
        pre = mname + "." if mname else ""
        for pname, _ in list(mod.named_parameters(recurse=False)) + list(mod.named_buffers(recurse=False)):
            if isinstance(mod, nn.modules.batchnorm._BatchNorm):
                leaf = "bn_" + pname
            elif isinstance(mod, (nn.LayerNorm, nn.GroupNorm)):
                # 1-D scales: drawn as BatchNorm's are
                leaf = "bn_weight" if pname == "weight" else "bias"
            elif isinstance(mod, nn.LSTM):
                leaf = "lstm_weight" if pname.startswith("weight") else "bias"
            elif isinstance(mod, (nn.ConvTranspose1d, nn.ConvTranspose2d)):
                leaf = "tconv_weight" if pname == "weight" else "bias"
            else:
                leaf = "weight" if pname == "weight" else "bias"
            kinds[pre + pname] = leaf
    return kinds


def weights(config: dict, seed: int, device: str) -> Dict[str, torch.Tensor]:
    """A state dict for the configuration's model, drawn on ``device`` from
    ``seed`` in one call and scaled leaf by leaf: weights by their fan-in so
    that activations stay of order 1, BatchNorm scales near 1, biases and
    running statistics small but not trivial, running variances positive.
    LayerNorm and GroupNorm scales are drawn as BatchNorm's."""
    model = reference_model(config)
    shapes = model.state_dict()
    kinds = _kinds(model)
    floats = {k: v for k, v in shapes.items() if v.is_floating_point()}
    total = sum(v.numel() for v in floats.values())
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    flat = torch.randn(total, generator=gen, device=device, dtype=torch.float32)
    out, at = {}, 0
    for k, v in shapes.items():
        if not v.is_floating_point():
            out[k] = torch.zeros(v.shape, dtype=v.dtype, device=device)
            continue
        n = v.numel()
        z = flat[at : at + n].view(v.shape)
        at += n
        leaf = kinds[k]
        if leaf in ("weight", "tconv_weight"):
            fan = v.shape[0] if leaf == "tconv_weight" else v.shape[1]
            fan *= int(np.prod(v.shape[2:])) if v.dim() > 2 else 1
            t = z * float(np.sqrt(2.0 / fan))
        elif leaf == "lstm_weight":
            t = z * float(0.5 / np.sqrt(v.shape[1]))
        elif leaf == "bn_weight":
            t = 1.0 + 0.1 * z
        elif leaf == "bn_running_var":
            t = 1.0 + 0.25 * z.abs()
        else:  # biases, BatchNorm shifts and running means
            t = 0.1 * z
        out[k] = t.contiguous()
    return out


# the seeded part of a near-identity denoiser, of the fan-in scale
PERTURBATION = 0.05


def denoiser_weights(config: dict, seed: int, device: str) -> Dict[str, torch.Tensor]:
    """The weights an identify cell's denoiser runs with: the identity along
    the model's outermost path plus a seeded perturbation (the kind's
    ``near_identity`` rule), so that its output is a spectrogram or a
    waveform like its input, as a trained denoiser's is, and the peaks and
    hashes after it are about as many as the input's on every seed (fully
    random weights make the matcher's work move with the seed)."""
    state = weights(config, seed, device)
    kind(config).near_identity(state, config["model_args"])
    return state


# ------------------------------------------------------------------ counts

@contextlib.contextmanager
def _no_autocast():
    with mock.patch.object(torch, "autocast", lambda *a, **k: contextlib.nullcontext()):
        yield


def forward_flops(config: dict, shape: Tuple[int, ...]) -> int:
    """Multiply-adds x 2 of one forward of the configuration's model on an
    input of ``shape``, from the shapes each layer sees (run on the meta
    device, so nothing is computed): every convolution as a direct
    convolution, the LSTM's gate products (4 gates x (input + hidden) per
    unit, step and direction, every layer) and every linear layer.
    Element-wise layers, normalisation and resampling are not counted, nor
    is what no module hook sees (a functional attention's products): a
    kind's ``batch_flops`` adds that."""
    from torch import nn

    model = reference_model(config).eval()
    total = 0

    def conv(mod, args, out):
        nonlocal total
        taps = int(np.prod(mod.kernel_size))
        if isinstance(mod, (nn.ConvTranspose1d, nn.ConvTranspose2d)):
            total += 2 * args[0].numel() * mod.out_channels * taps // mod.groups
        else:
            total += 2 * out.numel() * mod.in_channels * taps // mod.groups

    def lstm(mod, args, out):
        nonlocal total
        b, t = args[0].shape[:2]
        dirs = 2 if mod.bidirectional else 1
        for layer in range(mod.num_layers):
            width = mod.input_size if layer == 0 else dirs * mod.hidden_size
            total += 2 * b * t * dirs * 4 * mod.hidden_size * (width + mod.hidden_size)

    def linear(mod, args, out):
        nonlocal total
        total += 2 * out.numel() * mod.in_features

    hooks = []
    for m in model.modules():
        if isinstance(m, (nn.Conv1d, nn.Conv2d, nn.ConvTranspose1d, nn.ConvTranspose2d)):
            hooks.append(m.register_forward_hook(conv))
        elif isinstance(m, nn.LSTM):
            hooks.append(m.register_forward_hook(lstm))
        elif isinstance(m, nn.Linear):
            hooks.append(m.register_forward_hook(linear))
    with torch.no_grad(), _no_autocast():
        model(torch.empty(shape, device="meta"))
    for h in hooks:
        h.remove()
    return int(total)


def prune_work(B: int, F: int, C: int, fwd_peaks: int, kept_peaks: int,
               valid_cols: int = None) -> Tuple[Tuple[int, int], Tuple[int, int]]:
    """((bytes, operations) of the forward prune, the same of the backward)
    on a (B, F, C) spectrogram: every float32 cell read once and its mask
    byte written once (the backward reads the forward's masks too), the
    Gaussian row and the row counts; operations: five a cell for the
    forward's local maxima and threshold, one argmax round and one bump a
    tested peak, the backward's envelope over each valid column, a bump a
    kept peak, and each pass's initial envelope."""
    cells = B * F * C
    valid_cols = B * C if valid_cols is None else valid_cols
    spread = 2 * B * F * F
    fwd_ops = 5 * cells + F * fwd_peaks + 2 * F * fwd_peaks + spread
    bwd_ops = 2 * F * valid_cols + F * fwd_peaks + 2 * F * kept_peaks + spread
    fwd_bytes = cells * 4 + cells + F * 4
    bwd_bytes = cells * 4 + 2 * cells + F * 4 + B * 4
    return (fwd_bytes, fwd_ops), (bwd_bytes, bwd_ops)


def least_seconds(nbytes: float, ops: float, flop_per_s: float, bytes_per_s: float) -> float:
    """The roofline's least time: the larger of the bytes' and the
    operations' time at the peaks."""
    return max(nbytes / bytes_per_s, ops / flop_per_s)


def unique_rows(th: np.ndarray) -> np.ndarray:
    """(N, 2) int32 (time, hash) rows -> their distinct rows, sorted."""
    if th.shape[0] == 0:
        return th.astype(np.int32).reshape(0, 2)
    packed = (th[:, 0].astype(np.uint64) << np.uint64(32)) + th[:, 1].astype(np.uint32).astype(np.uint64)
    u = np.unique(packed)
    return np.stack([u >> np.uint64(32), u & np.uint64(0xFFFFFFFF)], axis=1).astype(np.int32)


def row_set_difference(a: np.ndarray, b: np.ndarray) -> int:
    """Rows in one of two (N, 2) arrays and not the other."""
    pa = {(int(x), int(y)) for x, y in a}
    pb = {(int(x), int(y)) for x, y in b}
    return len(pa ^ pb)

