"""Denoiser training: the step, the plateau LR, early stopping, checkpoints
(port of musicfpaugment_tpu/train/trainer.py; TensorBoard and media logging
are not ported yet).

One training step: the clean batch goes to the device, ``AugmentFP`` degrades
it there (its draws are made on the host from the trainer's own seeded
generator), then spectrograms, the forward, the loss, the backward pass and
the Adam update. Two input types: ``"spec"`` (the UNet: L1 on per-example
max-normalised magnitude spectrograms, the running statistics updated) and
``"audio"`` (Demucs: L1 + multi-resolution STFT). Validation adds
the micro-PSNR and steps the plateau scheduler on the validation loss.

Precision: the whole step runs with cuDNN's TF32 off, backward pass
included, so a model with ``dtype=None`` trains in strict float32; a UNet
or a Demucs with ``dtype=torch.bfloat16`` computes its body in bfloat16 by
its own autocast. Parameters and Adam's state stay float32 either way.

As in the JAX package, an epoch runs exactly ``steps`` steps and averages
by ``steps``; a resumed run starts at the saved epoch, the last completed
one.
"""

from __future__ import annotations

import copy
import json
import os
import time
from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np
import torch
from torch import nn

from musicfpaugment_torch.augment.pipeline import AugmentFP
from musicfpaugment_torch.core.stft import magnitude_spectrogram
from musicfpaugment_torch.device import DeviceLike, cudnn_tf32, resolve_device
from musicfpaugment_torch.train.losses import l1_loss, multi_resolution_stft_loss, psnr


def spectrogram_batch(waveforms: torch.Tensor) -> torch.Tensor:
    """The model frontend: |STFT| / per-example max, n_fft 512 hop 256, the
    scaling that audfprint's denoiser hook sees at inference."""
    return magnitude_spectrogram(waveforms, n_fft=512, hop_length=256, per_example=True)


class EarlyStopping:
    """Stops after ``patience`` validation losses that do not beat the best
    by more than ``min_delta`` (the reference's quirky ``-inf`` start)."""

    def __init__(self, patience: int = 5, min_delta: float = 0.0) -> None:
        self.patience = patience
        self.min_delta = min_delta
        self.counter = 0
        self.best_loss = float("-inf")
        self.early_stop = False

    def __call__(self, val_loss: float) -> None:
        if self.best_loss == float("-inf") or self.best_loss - val_loss > self.min_delta:
            self.best_loss = val_loss
            self.counter = 0
        else:
            self.counter += 1
            print(f"INFO: Early stopping counter {self.counter} of {self.patience}")
            if self.counter >= self.patience:
                print("INFO: Early stopping")
                self.early_stop = True

    def state_dict(self) -> Dict[str, Any]:
        return {
            "patience": self.patience,
            "min_delta": self.min_delta,
            "counter": self.counter,
            "best_loss": self.best_loss,
            "early_stop": self.early_stop,
        }

    def load_state_dict(self, d: Dict[str, Any]) -> None:
        self.__dict__.update(d)


class ReduceLROnPlateau:
    """``torch.optim.lr_scheduler.ReduceLROnPlateau('min')`` semantics as a
    host-side scale of the base rate, with the JAX package's state keys: the
    trainer sets every parameter group's ``lr`` to ``base_lr * scale``
    before each step."""

    def __init__(
        self,
        factor: float = 0.1,
        patience: int = 10,
        threshold: float = 1e-4,
        min_lr: float = 0.0,
    ) -> None:
        self.factor = factor
        self.patience = patience
        self.threshold = threshold
        self.min_lr = min_lr
        self.best = float("inf")
        self.num_bad_epochs = 0
        self.scale = 1.0

    def step(self, metric: float) -> None:
        if metric < self.best * (1.0 - self.threshold):
            self.best = metric
            self.num_bad_epochs = 0
        else:
            self.num_bad_epochs += 1
        if self.num_bad_epochs > self.patience:
            self.scale = max(self.scale * self.factor, 0.0)
            self.num_bad_epochs = 0
            print(f"INFO: ReduceLROnPlateau — lr scale now {self.scale}")

    def state_dict(self) -> Dict[str, Any]:
        return {
            "factor": self.factor,
            "patience": self.patience,
            "threshold": self.threshold,
            "best": self.best,
            "num_bad_epochs": self.num_bad_epochs,
            "scale": self.scale,
        }

    def load_state_dict(self, d: Dict[str, Any]) -> None:
        self.__dict__.update(d)


class Trainer:
    """Training orchestration with checkpoint and resume.

    ``train_iter`` / ``val_iter`` yield clean (B, T) batches (numpy or
    tensors), or (clean, augmented) tuples; with an ``augmenter`` the
    augmented half is always made in the step. ``model`` carries its own
    weights (PyTorch builds them at construction) and the trainer takes them
    as given: a fresh :class:`Demucs` gets ``rescale_params(model, 0.1)``
    from its caller, as the CLI does (the JAX trainer applies it at init).
    ``example_batch`` is only checked to be a (B, T) batch. ``monitoring`` is accepted; the
    epoch's scalars are in ``history``. ``device``: ``None`` is CUDA.
    """

    def __init__(
        self,
        model: nn.Module,
        train_iter: Iterator,
        train_steps: int,
        val_iter: Iterator,
        val_steps: int,
        learning_rate: float,
        nb_epochs: int,
        checkpoint: str,
        input_type: str = "audio",
        augmenter: Optional[AugmentFP] = None,
        factor_sc: float = 0.5,
        factor_mag: float = 0.5,
        scheduler: Optional[ReduceLROnPlateau] = None,
        early_stopping: Optional[EarlyStopping] = None,
        save: bool = False,
        monitoring: bool = False,
        seed: int = 59,
        example_batch: Optional[np.ndarray] = None,
        cache_validation_set: bool = True,
        device: DeviceLike = None,
    ) -> None:
        if input_type not in ("spec", "audio"):
            raise ValueError(f"input_type must be 'spec' or 'audio', not {input_type!r}")
        if example_batch is not None and np.ndim(example_batch) != 2:
            raise ValueError("example_batch must be clean waveforms (B, T)")
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.train_iter = train_iter
        self.val_iter = val_iter
        self.train_steps = train_steps
        self.val_steps = val_steps
        self.nb_epochs = nb_epochs
        self.checkpoint = checkpoint
        self.input_type = input_type
        self.augmenter = self._on_device(augmenter)
        self.factor_sc = factor_sc
        self.factor_mag = factor_mag
        self.save = save
        self.monitoring = monitoring
        self.scheduler = scheduler or ReduceLROnPlateau()
        self.early_stopping = early_stopping or EarlyStopping()
        self.base_lr = learning_rate
        self.seed = seed
        self.epoch_start = 1
        self.min_valid_loss = float("inf")
        self.history: list = []
        # The first val_steps batches are kept and replayed with fixed draws
        # (batch i's from the Philox streams keyed by (seed + 1, example
        # index)), so the validation loss is a fixed target for the plateau
        # scheduler and early stopping.
        self.cache_validation_set = cache_validation_set
        self._val_cache: Optional[list] = None
        # the draws of training steps: on the host, whatever the device
        self._generator = torch.Generator().manual_seed(seed)
        self.step = 0
        self.optimizer = torch.optim.Adam(
            self.model.parameters(), lr=learning_rate, betas=(0.9, 0.999), eps=1e-8
        )
        self._maybe_resume()

    def _on_device(self, augmenter: Optional[AugmentFP]) -> Optional[AugmentFP]:
        """The augmenter with its banks on the trainer's device, moved once."""
        if augmenter is None or augmenter.device == self.device:
            return augmenter
        moved = copy.copy(augmenter)
        moved.device = self.device
        moved.noise_bank = augmenter.noise_bank.to(self.device)
        moved.ir_bank = augmenter.ir_bank.to(self.device)
        return moved

    # ------------------------------------------------------------ steps

    def _loss_terms(self, clean: torch.Tensor, aug: torch.Tensor):
        """(loss, terms, prediction, target) in the model's current mode."""
        if self.input_type == "spec":
            clean_in = spectrogram_batch(clean)
            pred = self.model(spectrogram_batch(aug))
            loss = l1_loss(pred, clean_in)
            return loss, {"loss": loss}, pred, clean_in
        pred = self.model(aug)
        l1 = l1_loss(pred, clean)
        sc, mag = multi_resolution_stft_loss(
            pred, clean, factor_sc=self.factor_sc, factor_mag=self.factor_mag
        )
        loss = l1 + sc + mag
        return loss, {"loss": loss, "l1_loss": l1, "sc_loss": sc, "mag_loss": mag}, pred, clean

    def _make_batch(self, clean: torch.Tensor, aug: Optional[torch.Tensor], draws=None):
        """The augmented batch: made on the device from ``draws`` (default:
        fresh ones from the trainer's generator) when there is an augmenter,
        else the loader's."""
        if self.augmenter is None:
            if aug is None:
                raise ValueError("a clean-only batch needs an augmenter")
            return aug
        if draws is None:
            draws = self.augmenter.draw(clean.shape[0], clean.shape[-1], self._generator)
        return self.augmenter.apply(clean, draws)

    def _get_batch(self, iterator) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        batch = next(iterator)
        clean, aug = batch if isinstance(batch, tuple) else (batch, None)

        def to_device(x):
            return torch.as_tensor(x, dtype=torch.float32).to(self.device)

        return to_device(clean), (to_device(aug) if aug is not None else None)

    def train_step(self, clean: torch.Tensor, aug: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        """One optimisation step on one batch; returns the loss terms (device
        scalars). The gradients stay in the parameters' ``.grad``."""
        aug = self._make_batch(clean, aug)
        for group in self.optimizer.param_groups:
            group["lr"] = self.base_lr * self.scheduler.scale
        self.model.train()
        self.optimizer.zero_grad(set_to_none=True)
        with cudnn_tf32(False):
            loss, terms, _, _ = self._loss_terms(clean, aug)
            loss.backward()
        self.optimizer.step()
        self.step += 1
        return {k: v.detach() for k, v in terms.items()}

    # ------------------------------------------------------------ epochs

    def train_epoch(self, epoch: int) -> Dict[str, float]:
        acc: Dict[str, torch.Tensor] = {}
        for _ in range(self.train_steps):
            for k, v in self.train_step(*self._get_batch(self.train_iter)).items():
                acc[k] = acc[k] + v if k in acc else v
        return {k: float(v) / self.train_steps for k, v in acc.items()}

    def _val_batches(self):
        """(clean, aug, draws) for each validation step."""
        if not self.cache_validation_set:
            return (self._get_batch(self.val_iter) + (None,) for _ in range(self.val_steps))
        if self._val_cache is None:
            self._val_cache = []
            for i in range(self.val_steps):
                clean, aug = self._get_batch(self.val_iter)
                draws = None
                if self.augmenter is not None:
                    b = clean.shape[0]
                    draws = self.augmenter.draw_indexed(
                        range(i * b, (i + 1) * b), clean.shape[-1], self.seed + 1
                    )
                self._val_cache.append((clean, aug, draws))
        return iter(self._val_cache)

    @torch.no_grad()
    def validation_epoch(self) -> Tuple[Dict[str, float], Dict[str, float]]:
        self.model.eval()
        acc: Dict[str, torch.Tensor] = {}
        for clean, aug, draws in self._val_batches():
            aug = self._make_batch(clean, aug, draws)
            with cudnn_tf32(False):
                _, terms, pred, target = self._loss_terms(clean, aug)
            terms["psnr"] = psnr(pred, target)
            for k, v in terms.items():
                acc[k] = acc[k] + v if k in acc else v
        out = {k: float(v) / self.val_steps for k, v in acc.items()}
        metrics = {"psnr": out.pop("psnr")}
        self.scheduler.step(out["loss"])
        return out, metrics

    def start_epoch(self) -> None:
        """Validation metrics before training."""
        val_losses, val_metrics = self.validation_epoch()
        print(f"Baseline validation loss: {val_losses}")
        print(f"Baseline validation metrics: {val_metrics}")

    def training_loop(self) -> None:
        min_valid_loss = self.min_valid_loss
        for epoch in range(self.epoch_start, self.nb_epochs):
            if self.early_stopping.early_stop:
                break
            t0 = time.time()
            train_loss = self.train_epoch(epoch)
            print(f"\nEpoch {epoch}: {time.time() - t0:.2f} training seconds")
            print(f"Training Loss: {train_loss}")

            t0 = time.time()
            val_losses, val_metrics = self.validation_epoch()
            print(f"Epoch {epoch}: {time.time() - t0:.2f} validation seconds")
            print(f"Validation Loss: {val_losses} Metrics: {val_metrics}")

            self.early_stopping(val_losses["loss"])
            self.history.append(
                {"epoch": epoch, "train": train_loss, "val": val_losses, "metrics": val_metrics}
            )

            if min_valid_loss > val_losses["loss"]:
                print(f"Validation loss decreased from {min_valid_loss} to {val_losses['loss']}.")
                min_valid_loss = val_losses["loss"]
                self.min_valid_loss = min_valid_loss
                if self.save:
                    self._save_checkpoint("best_epoch", epoch)
            if self.save:
                self._save_checkpoint("last_epoch", epoch)

    # ------------------------------------------------------------ ckpt

    def _ckpt_dir(self, name: str) -> str:
        return os.path.join(os.path.abspath(self.checkpoint), name)

    def _save_checkpoint(self, name: str, epoch: int) -> None:
        """``state.pt`` (model, optimizer, step, the draws' generator) and
        ``trainer_meta.json`` with the JAX package's keys."""
        path = self._ckpt_dir(name)
        os.makedirs(path, exist_ok=True)
        torch.save(
            {
                "model": self.model.state_dict(),
                "optimizer": self.optimizer.state_dict(),
                "step": self.step,
                "generator": self._generator.get_state(),
            },
            os.path.join(path, "state.pt"),
        )
        meta = {
            "epoch": epoch,
            "best_val_loss": self.min_valid_loss,
            "scheduler": self.scheduler.state_dict(),
            "early_stopping": self.early_stopping.state_dict(),
        }
        with open(os.path.join(path, "trainer_meta.json"), "w") as f:
            json.dump(meta, f)

    def _maybe_resume(self) -> None:
        path = self._ckpt_dir("last_epoch")
        if not os.path.exists(os.path.join(path, "trainer_meta.json")):
            os.makedirs(self.checkpoint, exist_ok=True)
            return
        print(f"\nLoading checkpoint {path}.")
        state = torch.load(os.path.join(path, "state.pt"), map_location=self.device, weights_only=True)
        self.model.load_state_dict(state["model"])
        self.optimizer.load_state_dict(state["optimizer"])
        self.step = int(state["step"])
        self._generator.set_state(state["generator"].cpu())
        with open(os.path.join(path, "trainer_meta.json")) as f:
            meta = json.load(f)
        self.epoch_start = meta["epoch"]
        self.min_valid_loss = meta["best_val_loss"]
        self.scheduler.load_state_dict(meta["scheduler"])
        self.early_stopping.load_state_dict(meta["early_stopping"])
        print(f"Minimum validation loss is {self.min_valid_loss}...")
        print(f"Epoch is {self.epoch_start}...")
