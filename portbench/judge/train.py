"""The plain reference of the first training steps, and the comparison that
decides ``correct`` in the training cell.

The reference is the frozen UNet (its dropout the plain threefry masks),
the frozen augmenter and L1 loss, and ``torch.optim.Adam``, started from
the benchmark's weights and driven through the same batches under the
same keys as the program's ``Trainer`` (its key stream split as the
trainer splits it: each step's key, then its augmentation and dropout
halves). Compared: each step's loss; the augmented batches; the norm of
each leaf's first gradient (the program's worked out from Adam's first
moment after one step); the norm of each leaf's change over the steps.
A leaf's gap of norms is taken against the reference's norm of that leaf
or of the median leaf, whichever is larger; leaves whose reference
gradient is under a thousandth of the median leaf's move by round-off
alone under Adam and are left out of the change.

Precisions: ``strict`` is the configuration's float32 with TF32 off;
``tf32`` lets cuDNN use TF32 forward and backward (the control). The
fault ``half_batch`` takes the loss over the first half of each batch.
"""

from __future__ import annotations

import os
import sys
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from portbench import harness as H
from portbench import inputs as I
from portbench.judge.identify import precision_of

BETA1, BETA2, EPS = 0.9, 0.999, 1e-8
STEP_RATIO_FLOOR = 1e-3  # a leaf below this share of the median gradient is left out


def record_steps(trainer, batches: Sequence[torch.Tensor]) -> dict:
    """Run the trainer's first steps through ``train_step`` and keep what
    the judge reads."""
    named = list(trainer.model.named_parameters())
    rec = {"p0": {n: p.detach().clone() for n, p in named}, "losses": [], "augmented": []}
    aug = trainer.augmenter
    orig = aug.apply

    def apply(x, draws):
        out = orig(x, draws)
        rec["augmented"].append(out.detach().clone())
        return out

    aug.apply = apply
    try:
        for i, b in enumerate(batches):
            rec["losses"].append(float(trainer.train_step(b)["loss"]))
            if i == 0:
                # an optimizer that kept no moment got no gradient
                state = trainer.optimizer.state
                rec["g1"] = {n: (state[p]["exp_avg"] / (1 - BETA1)).clone()
                             if "exp_avg" in state.get(p, {}) else torch.zeros_like(p)
                             for n, p in named}
    finally:
        del aug.apply
    rec["p_end"] = {n: p.detach().clone() for n, p in named}
    return rec


def reference_steps(config: dict, traffic: dict, seeds: Dict[str, int], banks, batches,
                    device: str, precision: str = "strict", fault: Optional[str] = None) -> dict:
    """The reference's first steps from the benchmark's weights on the same
    batches and keys, in the record's form."""
    from portbench.ref import device as RDEV
    from portbench.ref.augment.pipeline import AugmentFP
    from portbench.ref.core import prng
    from portbench.ref.core.stft import magnitude_spectrogram
    from portbench.ref.train.losses import l1_loss

    def spec(x):
        return magnitude_spectrogram(x, n_fft=512, hop_length=256, per_example=True)

    model = I.reference_model(config, device="cpu")
    model.load_state_dict({k: v.cpu() for k, v in I.weights(config, seeds["weights"], device).items()})
    model = model.to(device).train()
    named = list(model.named_parameters())
    opt = torch.optim.Adam(model.parameters(), lr=traffic["lr"], betas=(BETA1, BETA2), eps=EPS)
    noise, irs = banks
    cond = H.read_json(os.path.join("portbench", "traffic", "conditions",
                                    traffic["condition"] + ".json"))
    aug = AugmentFP(noise, noise.sample_rate, parameters=cond, impulse_response_dir=irs,
                    device=device)
    key = prng.key(seeds["trainer"])
    rec = {"p0": {n: p.detach().clone() for n, p in named}, "losses": [], "augmented": []}
    for i, clean in enumerate(batches):
        key, k = prng.split(key).unbind(-2)
        k_aug, k_drop = prng.split(k).unbind(-2)
        clean = clean.to(device)
        x = aug.apply(clean, aug.draw(clean.shape[0], clean.shape[-1], k_aug))
        rec["augmented"].append(x.detach().clone())
        opt.zero_grad(set_to_none=True)
        with precision_of(config, precision), RDEV.cudnn_tf32(precision == "tf32"):
            pred = model(spec(x), dropout_key=k_drop, batch_offset=0)
            target = spec(clean)
            if fault == "half_batch":
                half = pred.shape[0] // 2
                pred, target = pred[:half], target[:half]
            loss = l1_loss(pred, target)
            loss.backward()
        opt.step()
        rec["losses"].append(float(loss.detach()))
        if i == 0:
            rec["g1"] = {n: p.grad.detach().clone() for n, p in named}
    rec["p_end"] = {n: p.detach().clone() for n, p in named}
    return rec


def _worst_leaf(got: Dict[str, torch.Tensor], want: Dict[str, torch.Tensor],
                keep: Sequence[str]) -> float:
    norms_w = {n: float(torch.linalg.vector_norm(want[n].double())) for n in keep}
    median = float(np.median(list(norms_w.values())))
    worst = 0.0
    for n in keep:
        g = float(torch.linalg.vector_norm(got[n].to(want[n].device).double()))
        worst = max(worst, abs(g - norms_w[n]) / max(norms_w[n], median, 1e-30))
    return worst


def compare(got: dict, want: dict) -> Dict[str, float]:
    """The numbers compared: each step's loss gap over the reference's
    loss, the augmented batches' largest gap over their largest value, and
    the worst leaf's gap of norms of the first gradient and of the change."""
    out = {}
    for i, (a, b) in enumerate(zip(got["losses"], want["losses"])):
        out[f"loss.step{i + 1}"] = abs(a - b) / max(abs(b), 1e-30)
    top = max(float(x.abs().max()) for x in want["augmented"])
    out["augmented_rel"] = max(float((a.to(b.device) - b).abs().max())
                               for a, b in zip(got["augmented"], want["augmented"])) / top
    names = list(want["g1"])
    out["grad1_leaf"] = _worst_leaf(got["g1"], want["g1"], names)
    gnorm = {n: float(torch.linalg.vector_norm(want["g1"][n].double())) for n in names}
    median = float(np.median(list(gnorm.values())))
    moved = [n for n in names if gnorm[n] >= STEP_RATIO_FLOOR * median]
    if len(moved) < len(names):
        print(f"portbench: leaves left out of the change: {sorted(set(names) - set(moved))}",
              file=sys.stderr)
    change_g = {n: got["p_end"][n].to(want["p0"][n].device) - got["p0"][n].to(want["p0"][n].device)
                for n in moved}
    change_w = {n: want["p_end"][n] - want["p0"][n] for n in moved}
    out[f"change{len(want['losses'])}_leaf"] = _worst_leaf(change_g, change_w, moved)
    return out


def judge(run: H.Run, st: dict, record: dict, precision: str = "strict") -> List[H.Check]:
    """The program's recorded steps against the reference's."""
    n = len(record["losses"])
    want = reference_steps(run.config, run.traffic, st["seeds"], st["banks"], st["batches"][:n],
                           run.device, precision)
    numbers = compare(record, want)
    limits = H.read_json(os.path.join("portbench", "limits", run.cell["name"] + ".json"))
    return [H.Check(k, v, limits["limits"][k]) for k, v in numbers.items()]
