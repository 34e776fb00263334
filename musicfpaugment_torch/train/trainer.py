"""Denoiser training: the step, the plateau LR, early stopping, checkpoints,
TensorBoard monitoring and data-parallel training (port of
musicfpaugment_tpu/train/trainer.py).

The model starts where the JAX trainer's starts: Flax's initialisers under
``PRNGKey(0)`` (``models.flax_init``), then the rescale for a Demucs.

One training step: the clean batch goes to the device, ``AugmentFP`` degrades
it there (its draws are made on the host under the first half of the step's
threefry key, split from ``PRNGKey(seed)`` as the JAX trainer splits its
keys, so a step's augmented batch is the JAX trainer's), then spectrograms,
the forward (the UNet's dropout draws Flax's masks under the second half),
the loss, the backward pass and the Adam update. Two input types: ``"spec"``
(the UNet: L1 on per-example max-normalised magnitude spectrograms, the
running statistics updated) and ``"audio"`` (Demucs: L1 + multi-resolution
STFT). Validation adds the micro-PSNR and steps the plateau scheduler on the
validation loss.

Precision: the whole step runs with cuDNN's TF32 off, backward pass
included, so a model with ``dtype=None`` trains in strict float32; a UNet
or a Demucs with ``dtype=torch.bfloat16`` computes its body in bfloat16 by
its own autocast. Parameters and Adam's state stay float32 either way.
The step's, validation's and the media triplet's convolutions run under
``device.cudnn_measured``: cuDNN times engines for each convolution problem
the first time the process meets it and keeps the fastest (on an H100 at
128 x 257 x 94 spectrograms, the heuristic's FFT tiling made the UNet's
step twice as long), so the first step of a new clip length pays for that
timing; the augmenter's filters keep cuDNN's heuristic.

As in the JAX package, an epoch runs exactly ``steps`` steps and averages
by ``steps``; a resumed run starts at the saved epoch, the last completed
one.

Data parallelism: when a ``torch.distributed`` process group is up
(``parallel.init_multihost``), the model trains under
``DistributedDataParallel``. Every rank reads the same global batch and the
same draws (under the same key) and takes its slice, and the
UNet's BatchNorm normalises by the global batch's statistics and its dropout
takes the rank's slice of the global batch's masks, so N ranks compute what
one process computes on the global batch. The loss terms and the PSNR are
reduced over the ranks; rank 0 writes the checkpoints and the monitoring,
every rank resumes from the checkpoints.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np
import torch
from torch import nn

from musicfpaugment_torch.augment.pipeline import AugmentFP
from musicfpaugment_torch.core import prng
from musicfpaugment_torch.core.stft import magnitude_spectrogram
from musicfpaugment_torch.device import DeviceLike, cudnn_measured, resolve_device
from musicfpaugment_torch.models import Demucs, UNet, flax_init, rescale_params
from musicfpaugment_torch.parallel.augment_sharded import shard_draws
from musicfpaugment_torch.train.losses import l1_loss, multi_resolution_stft_loss, psnr
from musicfpaugment_torch.train.utils import get_rank, get_world_size, is_dist_avail_and_initialized
from musicfpaugment_torch.utils.profiling import annotate, count


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
    augmented half is always made in the step. A :class:`UNet` or
    :class:`Demucs` ``model`` is initialised here as the JAX trainer
    initialises its model, whatever weights it held: Flax's initialisers
    under ``PRNGKey(0)`` and, for a Demucs, ``rescale_params(model, 0.1)``
    (a resume then loads the checkpoint); any other module keeps its
    weights. To train from given weights, load them after construction.
    ``example_batch`` is only checked to be a (B, T) batch whose size the
    number of ranks divides. With ``monitoring`` each epoch's scalars go to
    ``writer`` and every 10th epoch a validation triplet (clean, augmented,
    denoised) too; ``writer`` defaults to a ``SummaryWriter`` under
    ``<checkpoint>/tb`` where ``tensorboard`` imports, and without one the
    scalars stay in ``history`` alone. ``device``: ``None`` is CUDA.
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
        writer: Any = None,
    ) -> None:
        if input_type not in ("spec", "audio"):
            raise ValueError(f"input_type must be 'spec' or 'audio', not {input_type!r}")
        if example_batch is not None and np.ndim(example_batch) != 2:
            raise ValueError("example_batch must be clean waveforms (B, T)")
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        if isinstance(model, (UNet, Demucs)):
            flax_init(model)
            if isinstance(model, Demucs):
                rescale_params(model, reference=0.1)
        self.world, self.rank = get_world_size(), get_rank()
        if example_batch is not None:
            self._bounds(len(example_batch))
        self.train_iter = train_iter
        self.val_iter = val_iter
        self.train_steps = train_steps
        self.val_steps = val_steps
        self.nb_epochs = nb_epochs
        self.checkpoint = checkpoint
        self.input_type = input_type
        self.augmenter = augmenter.to(self.device) if augmenter is not None else None
        self.factor_sc = factor_sc
        self.factor_mag = factor_mag
        self.save = save
        self.monitoring = monitoring
        self.writer = writer
        self.scheduler = scheduler or ReduceLROnPlateau()
        self.early_stopping = early_stopping or EarlyStopping()
        self.base_lr = learning_rate
        self.seed = seed
        self.epoch_start = 1
        self.min_valid_loss = float("inf")
        self.history: list = []
        # The first val_steps batches are kept and replayed with fixed draws
        # (batch i's under fold_in(PRNGKey(seed + 1), i), as in the JAX
        # trainer), so the validation loss is a fixed target for the plateau
        # scheduler and early stopping.
        self.cache_validation_set = cache_validation_set
        self._val_cache: Optional[list] = None
        # the stream of step keys (drawn on the host, whatever the device);
        # each step's key splits into the augmentation's key and dropout's
        self._key = prng.key(seed)
        self.step = 0
        # the model input shapes of the steps run so far (``trainer.tuned_shapes``)
        self._step_shapes: set = set()
        self.optimizer = torch.optim.Adam(
            self.model.parameters(), lr=learning_rate, betas=(0.9, 0.999), eps=1e-8
        )
        self._maybe_resume()
        # the module the training forward runs through
        self._train_model: nn.Module = self.model
        if is_dist_avail_and_initialized():
            self._wrap_ddp()

    def _wrap_ddp(self) -> None:
        """``DistributedDataParallel`` over the model (its gradients are
        averaged over the ranks) with global-batch BatchNorm statistics on
        more than one rank (on one, the local statistics are the global
        ones); the running statistics are then the same on every rank, so
        no buffer is broadcast."""
        from torch.nn.parallel import DistributedDataParallel

        from musicfpaugment_torch.models.unet import FlaxBatchNorm2d

        for m in self.model.modules():
            if isinstance(m, FlaxBatchNorm2d):
                m.distributed = self.world > 1
        self._train_model = DistributedDataParallel(
            self.model, device_ids=[self.device] if self.device.type == "cuda" else None,
            broadcast_buffers=False,
        )

    # ------------------------------------------------------------ steps

    def _bounds(self, batch: int) -> Tuple[int, int]:
        """This rank's slice of a global batch of ``batch`` examples."""
        if batch % self.world:
            raise ValueError(
                f"batch {batch} does not divide by the {self.world} ranks: a process "
                "cannot leave its group, so the batch size must be a multiple of the "
                "world size (the JAX trainer shrinks its device mesh instead)"
            )
        b = batch // self.world
        return self.rank * b, (self.rank + 1) * b

    def _loss_terms(self, clean: torch.Tensor, aug: torch.Tensor, model: Optional[nn.Module] = None,
                    dropout: Optional[Tuple[torch.Tensor, int]] = None):
        """(loss, terms, prediction, target) in the model's current mode;
        the model's input in its parameters' dtype. ``dropout``: the step's
        dropout key and this rank's first example in the global batch, for
        a training forward of the UNet."""
        model = model if model is not None else self.model
        dtype = next(self.model.parameters()).dtype
        if self.input_type == "spec":
            clean_in = spectrogram_batch(clean)
            kw = {}
            if dropout is not None and isinstance(self.model, UNet):
                kw = {"dropout_key": dropout[0], "batch_offset": dropout[1]}
            pred = model(spectrogram_batch(aug).to(dtype), **kw)
            loss = l1_loss(pred, clean_in)
            return loss, {"loss": loss}, pred, clean_in
        pred = model(aug.to(dtype))
        l1 = l1_loss(pred, clean)
        sc, mag = multi_resolution_stft_loss(
            pred, clean, factor_sc=self.factor_sc, factor_mag=self.factor_mag
        )
        loss = l1 + sc + mag
        return loss, {"loss": loss, "l1_loss": l1, "sc_loss": sc, "mag_loss": mag}, pred, clean

    def _next_key(self) -> torch.Tensor:
        self._key, k = prng.split(self._key).unbind(-2)
        return k

    def _augment_draws(self, key, batch: int, num_samples: int):
        """The draws of a whole global batch under a step's key: its first
        half, as the JAX trainer's ``k_aug, k_drop = split(key)``."""
        k_aug, _ = prng.split(key).unbind(-2)
        return self.augmenter.draw(batch, num_samples, k_aug)

    def _make_batch(self, clean, aug, draws=None, key=None) -> Tuple[torch.Tensor, torch.Tensor]:
        """(clean, augmented) of this rank's slice of a global batch, on the
        device. The augmented half is made there from ``draws`` of the whole
        batch (default: under the step key ``key``, else the next one) when
        there is an augmenter, else taken from the loader."""
        clean = torch.as_tensor(clean)
        lo, hi = self._bounds(clean.shape[0])
        local = clean[lo:hi].to(self.device)
        if self.augmenter is None:
            if aug is None:
                raise ValueError("a clean-only batch needs an augmenter")
            return local, torch.as_tensor(aug)[lo:hi].to(self.device)
        if draws is None:
            key = self._next_key() if key is None else key
            draws = self._augment_draws(key, clean.shape[0], clean.shape[-1])
        return local, self.augmenter.apply(local, shard_draws(draws, lo, hi))

    def _get_batch(self, iterator) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """The loader's next (clean, augmented or None) global batch,
        float32 on the host."""
        batch = next(iterator)
        clean, aug = batch if isinstance(batch, tuple) else (batch, None)

        def as_f32(x):
            return torch.as_tensor(x, dtype=torch.float32)

        return as_f32(clean), (as_f32(aug) if aug is not None else None)

    def train_step(self, clean: torch.Tensor, aug: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        """One optimisation step on one global batch (this rank takes its
        slice); returns this rank's loss terms (device scalars). The
        gradients stay in the parameters' ``.grad``. Every step takes the
        next step key, as the JAX trainer's does: its first half augments,
        its second drops."""
        with annotate("trainer.step"):
            key = self._next_key()
            lo = self._bounds(torch.as_tensor(clean).shape[0])[0]
            clean, aug = self._make_batch(clean, aug, key=key)
            k_drop = prng.split(key).unbind(-2)[1]
            for group in self.optimizer.param_groups:
                group["lr"] = self.base_lr * self.scheduler.scale
            self.model.train()
            self.optimizer.zero_grad(set_to_none=True)
            if aug.shape not in self._step_shapes:
                # cuDNN times the new shape's convolution problems in this
                # step, unless another trainer of the process met them first
                self._step_shapes.add(aug.shape)
                count("trainer.tuned_shapes")
            with cudnn_measured():
                with annotate("trainer.forward"):
                    loss, terms, _, _ = self._loss_terms(clean, aug, self._train_model, (k_drop, lo))
                with annotate("trainer.backward"):
                    loss.backward()
            with annotate("trainer.optimizer"):
                self.optimizer.step()
            self.step += 1
            return {k: v.detach() for k, v in terms.items()}

    def _rank_mean(self, acc: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Per-rank sums -> their mean over the ranks (equal slices: the
        global batch's value)."""
        if self.world == 1:
            return acc
        import torch.distributed as dist

        keys = sorted(acc)
        packed = torch.stack([acc[k].to(torch.float64) for k in keys])
        dist.all_reduce(packed)
        return {k: v / self.world for k, v in zip(keys, packed)}

    def _psnr(self, pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        """:func:`psnr` of the global batch: the data range and the mean
        squared error over every rank's slice."""
        if self.world == 1:
            return psnr(pred, target)
        import torch.distributed as dist

        top = torch.stack([torch.maximum(pred, target).max(), -torch.minimum(pred, target).min()])
        dist.all_reduce(top, op=dist.ReduceOp.MAX)
        sse = torch.stack([((pred - target) ** 2).sum().to(torch.float64),
                           torch.tensor(float(pred.numel()), dtype=torch.float64, device=pred.device)])
        dist.all_reduce(sse)
        mse = (sse[0] / sse[1]).to(pred.dtype)
        return 10.0 * torch.log10((top[0] + top[1]) ** 2 / torch.clamp(mse, min=1e-12))

    # ------------------------------------------------------------ epochs

    def train_epoch(self, epoch: int) -> Dict[str, float]:
        acc: Dict[str, torch.Tensor] = {}
        for _ in range(self.train_steps):
            for k, v in self.train_step(*self._get_batch(self.train_iter)).items():
                acc[k] = acc[k] + v if k in acc else v
        return {k: float(v) / self.train_steps for k, v in self._rank_mean(acc).items()}

    def _val_batches(self):
        """(clean, augmented) of this rank's slice for each validation
        step."""
        if not self.cache_validation_set:
            return (self._make_batch(*self._get_batch(self.val_iter), key=self._next_key())
                    for _ in range(self.val_steps))
        if self._val_cache is None:
            self._val_cache = []
            for i in range(self.val_steps):
                clean, aug = self._get_batch(self.val_iter)
                b = clean.shape[0]
                lo, hi = self._bounds(b)
                if self.augmenter is None:
                    self._val_cache.append(self._make_batch(clean, aug) + (None,))
                    continue
                key = prng.fold_in(prng.key(self.seed + 1), i)
                draws = shard_draws(self._augment_draws(key, b, clean.shape[-1]), lo, hi)
                self._val_cache.append((clean[lo:hi].to(self.device), None, draws))
        return (
            (clean, aug if draws is None else self.augmenter.apply(clean, draws))
            for clean, aug, draws in self._val_cache
        )

    @torch.no_grad()
    def validation_epoch(self) -> Tuple[Dict[str, float], Dict[str, float]]:
        self.model.eval()
        acc: Dict[str, torch.Tensor] = {}
        for clean, aug in self._val_batches():
            with cudnn_measured():
                _, terms, pred, target = self._loss_terms(clean, aug)
            terms["psnr"] = self._psnr(pred, target)
            for k, v in terms.items():
                acc[k] = acc[k] + v if k in acc else v
        out = {k: float(v) / self.val_steps for k, v in self._rank_mean(acc).items()}
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
        main = self.rank == 0
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
                if self.save and main:
                    self._save_checkpoint("best_epoch", epoch)
            if self.save and main:
                self._save_checkpoint("last_epoch", epoch)
            if self.monitoring and main:
                self._log_tensorboard(epoch, train_loss, val_losses, val_metrics)
                if epoch % 10 == 0:
                    self._log_media(epoch)

    # ------------------------------------------------------------ ckpt

    def _ckpt_dir(self, name: str) -> str:
        return os.path.join(os.path.abspath(self.checkpoint), name)

    def _save_checkpoint(self, name: str, epoch: int) -> None:
        """``state.pt`` (model, optimizer, step, the stream's key) and
        ``trainer_meta.json`` with the JAX package's keys."""
        path = self._ckpt_dir(name)
        os.makedirs(path, exist_ok=True)
        torch.save(
            {
                "model": self.model.state_dict(),
                "optimizer": self.optimizer.state_dict(),
                "step": self.step,
                "key": self._key,
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
        self._key = state["key"].cpu()
        with open(os.path.join(path, "trainer_meta.json")) as f:
            meta = json.load(f)
        self.epoch_start = meta["epoch"]
        self.min_valid_loss = meta["best_val_loss"]
        self.scheduler.load_state_dict(meta["scheduler"])
        self.early_stopping.load_state_dict(meta["early_stopping"])
        print(f"Minimum validation loss is {self.min_valid_loss}...")
        print(f"Epoch is {self.epoch_start}...")

    # ------------------------------------------------------------ logging

    @torch.no_grad()
    def _media_triplet(self, clean: torch.Tensor, aug: torch.Tensor):
        """(augmented, denoised) of a validation batch, the model in
        evaluation mode: the denoised spectrogram ("spec") or waveform
        ("audio")."""
        self.model.eval()
        dtype = next(self.model.parameters()).dtype
        with cudnn_measured():
            if self.input_type == "spec":
                return aug, self.model(spectrogram_batch(aug).to(dtype))
            return aug, self.model(aug.to(dtype))

    def _log_media(self, epoch: int) -> None:
        """Wav and spectrogram triplets of the first validation batch: the
        waveform triplet for "audio"; for "spec" the spectrogram triplet
        (the UNet's output is a spectrogram)."""
        from musicfpaugment_torch.train import callbacks

        writer = self._get_tb_writer()
        if writer is None:
            return
        clean, aug = next(iter(self._val_batches()))
        aug_out, pred = self._media_triplet(clean, aug)
        if self.input_type == "audio":
            callbacks.monitor_audios(writer, clean, aug_out, pred, epoch, "val")
            callbacks.monitor_specs(writer, clean, aug_out, pred, epoch, "val")
        else:
            callbacks.monitor_specs_precomputed(
                writer, spectrogram_batch(clean[:3]), spectrogram_batch(aug_out[:3]), pred[:3],
                epoch=epoch, datas="val",
            )

    def _get_tb_writer(self):
        """``writer``, or a ``SummaryWriter`` under ``<checkpoint>/tb`` made
        on first use; ``None`` where ``tensorboard`` does not import."""
        if self.writer is None:
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError:
                return None
            self.writer = SummaryWriter(os.path.join(self.checkpoint, "tb"))
        return self.writer

    def _log_tensorboard(self, epoch, train_loss, val_losses, val_metrics) -> None:
        """The epoch's scalars (they are in ``history`` either way)."""
        writer = self._get_tb_writer()
        if writer is None:
            return
        for prefix, values in (("train", train_loss), ("val", val_losses), ("val", val_metrics)):
            for k, v in values.items():
                writer.add_scalar(f"{prefix}/{k}", float(v), epoch)
        if hasattr(writer, "flush"):
            writer.flush()
