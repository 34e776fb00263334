"""AugmentFP, the music-degradation pipeline facade (port of
musicfpaugment_tpu/augment/pipeline.py).

The fixed 8-stage chain HighPass -> ImpulseResponse -> BackgroundNoise ->
Gain -> Clipping -> LowPass -> HighPass -> PeakNormalization(p=1), with the
same ``parameters`` dict keys and constructor arguments as the JAX package,
over device-resident noise/IR banks. One call augments a whole batch on the
device; there is no per-call disk I/O.

Randomness is apart from arithmetic. ``draw`` makes the chain's per-example
parameters (one dict per stage) under a threefry key, following the JAX
package's key tree (``core/prng.py``): ``batch_augment(x, key=k)`` draws
what the JAX package's ``batch_augment(x, key=k)`` draws, and
``batch_augment_indexed`` folds each example's index into the base key as
the JAX package's does. The keys are words, so the draws are the same on the
CPU and on the card; ``apply`` is the deterministic chain on given draws;
``batch_augment`` is both.
"""

from __future__ import annotations

import copy
from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from musicfpaugment_torch.augment.banks import (
    IRBank,
    NoiseBank,
    build_ir_bank,
    build_noise_bank,
)
from musicfpaugment_torch.augment.compose import Compose
from musicfpaugment_torch.augment.constants import (
    DEFAULT_PARAMETERS,
    IMPULSE_RESPONSE_DIR,
)
from musicfpaugment_torch.augment.transforms import (
    AddBackgroundNoise,
    ApplyImpulseResponse,
    Clipping,
    Draws,
    Gain,
    HighPassFilter,
    Identity,
    LowPassFilter,
    PeakNormalization,
    fused_highpass_ir,
    fused_lowpass_highpass,
)
from musicfpaugment_torch.core import prng
from musicfpaugment_torch.device import DeviceLike, resolve_device
from musicfpaugment_torch.utils.profiling import annotate

Waveforms = Union[torch.Tensor, np.ndarray]


def _fresh_seed() -> int:
    return int(np.random.SeedSequence().entropy % (2**63))


class AugmentFP:
    """Music augmentation for audio fingerprinting.

    Args:
        background_paths: a ``{scene: [wav paths]}`` dict, a flat path list,
            a pre-decoded (N, T) numpy array, or a built :class:`NoiseBank`.
        sample_rate: waveform sample rate (8000 in all the paper's configs).
        parameters: the parameter dict (keys of ``DEFAULT_PARAMETERS``).
        impulse_response_dir: directory of IR wavs, an (N, T) array, or a
            built :class:`IRBank`.
        fuse_lti: run HPF1 with the reverb, and LPF2 with HPF3, as one
            convolution each (fast chain only). The default is the JAX
            package's. On an H100 the fused pairs take as long on the card
            as their stages and the call is slower on the host's clock, so
            ``fuse_lti=False`` is the faster setting there (PERF.md).
        device: where the banks live and the chain runs; ``None`` is CUDA.
            Built banks are moved there.
    """

    def __init__(
        self,
        background_paths: Union[Dict[str, List[str]], List[str], np.ndarray, NoiseBank],
        sample_rate: int,
        parameters: Dict[str, float] = DEFAULT_PARAMETERS,
        impulse_response_dir: Union[str, np.ndarray, IRBank] = IMPULSE_RESPONSE_DIR,
        noise_row_length: Optional[int] = None,
        batch_quantile_clipping: bool = False,
        fast_chain: bool = True,
        fuse_lti: bool = True,
        device: DeviceLike = None,
    ) -> None:
        self.device = resolve_device(device)
        if isinstance(background_paths, NoiseBank):
            self.noise_bank = background_paths.to(self.device)
        else:
            self.noise_bank = build_noise_bank(
                background_paths,
                sample_rate,
                row_length=noise_row_length or 8 * sample_rate,
                device=self.device,
            )
        if isinstance(impulse_response_dir, IRBank):
            self.ir_bank = impulse_response_dir.to(self.device)
        else:
            self.ir_bank = build_ir_bank(
                impulse_response_dir, sample_rate, device=self.device
            )

        self.sample_rate = sample_rate
        self.parameters = dict(parameters)
        self.batch_quantile_clipping = batch_quantile_clipping

        def ir_stage(normalize):
            return ApplyImpulseResponse(
                sample_rate=sample_rate,
                p=parameters["proba_ir_response"],
                normalize=normalize,
            )

        def noise_stage(normalize):
            return AddBackgroundNoise(
                p=parameters["proba_snr_in_db"],
                min_snr_in_db=parameters["min_snr_in_db"],
                max_snr_in_db=parameters["max_snr_in_db"],
                sample_rate=sample_rate,
                normalize=normalize,
            )

        # Fixed 8-stage chain.
        self.augmentation_pipeline = Compose(
            transforms=[
                HighPassFilter(
                    p=parameters["proba_cutoff_freq1"],
                    min_cutoff_freq=parameters["min_cutoff_freq1"],
                    max_cutoff_freq=parameters["max_cutoff_freq1"],
                    sample_rate=sample_rate,
                ),
                ir_stage(True),
                noise_stage(True),
                Gain(
                    p=parameters["proba_gain_in_db"],
                    min_gain_in_db=parameters["min_gain_in_db"],
                    max_gain_in_db=parameters["max_gain_in_db"],
                ),
                Clipping(
                    p=parameters["proba_percentile_threshold"],
                    min_percentile_threshold=0,
                    max_percentile_threshold=parameters["max_percentile_threshold"],
                    batch_quantile=batch_quantile_clipping,
                ),
                LowPassFilter(
                    p=parameters["proba_cutoff_freq2"],
                    min_cutoff_freq=parameters["min_cutoff_freq2"],
                    max_cutoff_freq=parameters["max_cutoff_freq2"],
                    sample_rate=sample_rate,
                ),
                HighPassFilter(
                    p=parameters["proba_cutoff_freq3"],
                    min_cutoff_freq=parameters["min_cutoff_freq3"],
                    max_cutoff_freq=parameters["max_cutoff_freq3"],
                    sample_rate=sample_rate,
                ),
                PeakNormalization(p=1),
            ]
        )

        # Fast chain: the final PeakNormalization(p=1) makes the whole chain
        # invariant to any positive per-example rescaling of intermediates:
        # every stage after HPF1 is positively homogeneous of degree 1 in its
        # input (convolutions and filters are linear; the noise mix scales its
        # noise by rms(signal); per-example clipping thresholds are quantiles
        # of the data, hence scale-equivariant). So the IR and noise stages'
        # peak normalizations and the entire Gain stage (a positive scalar
        # multiply) drop out of the final result exactly, up to float
        # rounding. Gain's key of the chain's split is kept by an Identity
        # placeholder so that the frozen-seed stream matches the exact chain
        # stage for stage. Disabled automatically for batch-quantile clipping
        # (thresholds couple examples across different scales there).
        self.fast_chain = fast_chain and not batch_quantile_clipping
        if self.fast_chain:
            tfms = list(self.augmentation_pipeline.transforms)
            tfms[1] = ir_stage(False)
            tfms[2] = noise_stage(False)
            tfms[3] = Identity()
            self._fast_pipeline = Compose(transforms=tfms)

        # LTI fusion: under the fast chain HPF1 and the IR reverb run as one
        # convolution with the combined kernel, and so do LPF2 and HPF3 (see
        # transforms.fused_highpass_ir, fused_lowpass_highpass). The draws
        # are those of the stage-by-stage chain; outputs differ only by
        # float rounding.
        self.fuse_lti = fuse_lti and self.fast_chain

        self.are_parameters_frozen = False
        self._key = prng.key(_fresh_seed())  # on the CPU, whatever the device

    @property
    def pipeline(self) -> Compose:
        """The chain that runs: the fast one unless it is switched off."""
        return self._fast_pipeline if self.fast_chain else self.augmentation_pipeline

    # ------------------------------------------------------------ draws

    def draw(self, batch: int, num_samples: int, key=None) -> List[Draws]:
        """The chain's per-example parameters for ``batch`` examples under
        ``key`` (default: the augmenter's own stream, which advances): one
        key per stage split from it, as the JAX package's chain does. A
        (batch, 2) batch of keys draws each example under its own."""
        with annotate("augment.draw"):
            if key is None:
                key = self._next_key()
            return self.pipeline.draw(
                key, batch, num_samples, self.sample_rate,
                noise_bank=self.noise_bank, ir_bank=self.ir_bank,
            )

    def draw_indexed(self, indices: Sequence[int], num_samples: int, base_key) -> List[Draws]:
        """Example ``i``'s draws under ``fold_in(base_key, indices[i])``, as
        a batch of one: a pure function of the base key and the index."""
        idx = torch.as_tensor(np.asarray(indices, np.int64))
        keys = prng.fold_in(prng.as_key(base_key, "cpu"), idx)
        return self.draw(len(idx), num_samples, keys)

    # ------------------------------------------------------------ chain

    def apply(self, waveforms: Waveforms, draws: Sequence[Draws]) -> torch.Tensor:
        """The deterministic chain on (batch, channels, time) or (batch,
        time) waveforms with the given per-stage draws."""
        with annotate("augment.apply"):
            samples = torch.as_tensor(waveforms, dtype=torch.float32, device=self.device)
            # a size-1 channel axis is stripped for the chain and restored after
            mono = samples.ndim == 3 and samples.shape[1] == 1
            if mono:
                samples = samples[:, 0, :]
            pipeline = self.pipeline
            banks = {"noise_bank": self.noise_bank, "ir_bank": self.ir_bank}
            if self.fuse_lti and samples.ndim == 2:
                tfms = pipeline.transforms
                out = fused_highpass_ir(samples, draws[0], draws[1], tfms[0], self.ir_bank)
                i = 2
                while i < len(tfms):
                    # trailing LPF2 -> HPF3 pair: one fused conv pass (HPF is a
                    # LowPassFilter subclass, so order the checks)
                    if (
                        i + 1 < len(tfms)
                        and isinstance(tfms[i], LowPassFilter)
                        and not isinstance(tfms[i], HighPassFilter)
                        and isinstance(tfms[i + 1], HighPassFilter)
                    ):
                        out = fused_lowpass_highpass(
                            out, draws[i], draws[i + 1], tfms[i], tfms[i + 1]
                        )
                        i += 2
                        continue
                    out = tfms[i].apply(out, draws[i], self.sample_rate, **banks)
                    i += 1
            else:
                out = pipeline.apply(samples, draws, self.sample_rate, **banks)
            return out[:, None, :] if mono else out

    # ------------------------------------------------------------ API

    def __call__(self, waveform: Waveforms, key=None) -> torch.Tensor:
        """Augment one waveform of shape (channels, time) or (time,)."""
        waveform = torch.as_tensor(waveform, dtype=torch.float32)
        squeeze_channel = waveform.ndim == 1
        if squeeze_channel:
            waveform = waveform[None, :]
        out = self.batch_augment(waveform[None], key=key)[0]
        return out[0] if squeeze_channel else out

    def batch_augment(self, waveforms: Waveforms, key=None) -> torch.Tensor:
        """Augment a batch (batch, channels, time) on the device under
        ``key`` (default: the next key of the augmenter's stream): draw,
        then apply."""
        draws = self.draw(waveforms.shape[0], waveforms.shape[-1], key)
        return self.apply(waveforms, draws)

    def batch_augment_indexed(
        self,
        waveforms: Waveforms,
        indices: Union[torch.Tensor, np.ndarray, Sequence[int]],
        base_key=None,
    ) -> torch.Tensor:
        """Batch-size-invariant augmentation: example ``i`` is augmented
        under ``fold_in(base_key, indices[i])`` (default base key: the
        frozen seed's key, else the next key of the stream), so a corpus
        processed in batches of 8 or 64 yields the same outputs. Used by
        frozen-seed query generation (testing/generate_queries.py).

        The draws never depend on the batch. The arithmetic is that of the
        libraries underneath: on the CPU with one thread the outputs are
        bit-identical for batch sizes that are multiples of 8, and within
        1e-6 of the peak for others (the vectorised complex product and the
        one-group convolution round the odd rows of a tensor differently)."""
        indices = [int(i) for i in indices]
        if base_key is None:
            # frozen: the frozen seed's key itself, not advanced, so that the
            # whole query set is a function of (seed, index) only
            base_key = self._key if self.are_parameters_frozen else self._next_key()
        draws = self.draw_indexed(indices, waveforms.shape[-1], base_key)
        if not self.batch_quantile_clipping:
            return self.apply(waveforms, draws)
        # batch quantiles couple the examples of one call: one call each
        return torch.cat([
            self.apply(waveforms[i : i + 1], [{k: v[i : i + 1] for k, v in d.items()} for d in draws])
            for i in range(len(indices))
        ])

    def to(self, device: DeviceLike) -> "AugmentFP":
        """This augmenter with its banks on ``device`` (itself if they are
        there already); the copy starts from the same key as this one."""
        device = resolve_device(device)
        if device == self.device:
            return self
        moved = copy.copy(self)
        moved.device = device
        moved.noise_bank = self.noise_bank.to(device)
        moved.ir_bank = self.ir_bank.to(device)
        return moved

    def _next_key(self) -> torch.Tensor:
        self._key, sub = prng.split(self._key).unbind(-2)
        return sub

    # ------------------------------------------------------------ freezing

    def freeze_parameters(self, seed: int = 0) -> None:
        """Reset the random stream to ``PRNGKey(seed)`` for reproducible
        query generation."""
        self.are_parameters_frozen = True
        self._key = prng.key(seed)

    def unfreeze_parameters(self) -> None:
        self.are_parameters_frozen = False
        self._key = prng.key(_fresh_seed())


def synthetic_banks(
    sample_rate: int = 8000,
    num_noise: int = 16,
    num_irs: int = 8,
    noise_row_length: Optional[int] = None,
    seed: int = 0,
    device: DeviceLike = None,
):
    """Small synthetic noise/IR banks for tests, demos, and benchmarks, built
    with numpy on the host (the same arrays as the JAX package's for the
    same seed) and put on ``device``.

    Noise rows are shaped noise bursts; IRs are exponentially-decaying sparse
    reflections, structurally similar to MIT-survey room responses.
    """
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    L = noise_row_length or 8 * sample_rate
    noise = rng.standard_normal((num_noise, L)).astype(np.float32)
    # color the noise a bit so scenes differ
    for i in range(num_noise):
        kernel = rng.standard_normal(8) / 8
        noise[i] = np.convolve(noise[i], kernel, mode="same")
    ir_len = sample_rate // 2
    t = np.arange(ir_len) / sample_rate
    irs = np.zeros((num_irs, ir_len), np.float32)
    for i in range(num_irs):
        decay = rng.uniform(2.0, 12.0)
        sparse = (rng.random(ir_len) < 0.02) * rng.standard_normal(ir_len)
        irs[i] = (sparse + 0.2 * rng.standard_normal(ir_len)) * np.exp(-decay * t)
        irs[i, 0] = 1.0
    noise_bank = build_noise_bank(noise, sample_rate, row_length=L, seed=seed, device=device)
    ir_bank = build_ir_bank(irs, sample_rate, device=device)
    return noise_bank, ir_bank


def dcase_shaped_banks(
    sample_rate: int = 8000,
    noise_row_length: Optional[int] = None,
    hours: float = 3.0,
    num_scenes: int = 15,
    num_irs: int = 271,
    seed: int = 0,
    device: DeviceLike = None,
):
    """Synthetic banks with the shape of the paper's corpora, built with
    numpy and scipy on the host (the same arrays as the JAX package's for
    the same seed) and put on ``device``.

    The paper's background-noise pool is the union of six DCASE
    acoustic-scene datasets grouped into ~15 scene labels, hours of audio
    per split, and its reverb pool is the 271-IR MIT acoustical-reflectance
    survey. The small ``synthetic_banks`` make each evaluation condition
    draw from a tiny degradation pool. These banks match the shape of the
    real corpora without shipping DCASE/MIT audio:

    - noise: ``hours`` of audio as row_length rows split across
      ``num_scenes`` synthetic scene timbres, each scene with a distinct FIR
      color, spectral tilt (leaky integrator), amplitude-modulation rhythm,
      optional mains-hum harmonics, and transient (click) density: the
      statistical knobs that distinguish DCASE scene classes;
    - IRs: ``num_irs`` room responses, T60 log-uniform in 0.1-1.2 s, sparse
      signed early reflections inside 50 ms, Gaussian late tail, unit direct
      path: the MIT survey's structure (direct + early + diffuse decay).
    """
    import scipy.signal as sps

    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    L = noise_row_length or 8 * sample_rate
    rows_total = max(num_scenes, int(hours * 3600 * sample_rate / L))
    base, extra = divmod(rows_total, num_scenes)
    t = np.arange(L, dtype=np.float32) / sample_rate
    scenes = {}
    for s in range(num_scenes):
        n_rows = base + (1 if s < extra else 0)
        kernel = (rng.standard_normal(33) * np.hanning(33)).astype(np.float32)
        tilt = rng.uniform(0.0, 0.95)  # leaky-integrator pole: white->brown
        am_rate = rng.uniform(0.1, 4.0)
        am_depth = rng.uniform(0.0, 0.8)
        hum_amp = rng.uniform(0.5, 2.0) if rng.random() < 0.4 else 0.0
        hum_f = float(rng.choice([50.0, 60.0, 100.0]))
        click_rate = rng.uniform(0.5, 3.0) if rng.random() < 0.5 else 0.0
        x = rng.standard_normal((n_rows, L)).astype(np.float32)
        x = sps.fftconvolve(x, kernel[None, :], mode="same", axes=-1)
        if tilt > 0:
            x = sps.lfilter([1.0], [1.0, -tilt], x, axis=-1).astype(np.float32)
        if am_depth > 0:
            phase = rng.uniform(0, 2 * np.pi, (n_rows, 1)).astype(np.float32)
            x *= 1.0 - am_depth / 2 + (am_depth / 2) * np.sin(
                2 * np.pi * am_rate * t[None, :] + phase
            )
        if hum_amp > 0:
            phase = rng.uniform(0, 2 * np.pi, (n_rows, 1)).astype(np.float32)
            rms = np.sqrt(np.mean(x**2, axis=-1, keepdims=True))
            for harm, amp in ((1, 1.0), (2, 0.4)):
                x += (hum_amp * amp * rms) * np.sin(
                    2 * np.pi * hum_f * harm * t[None, :] + phase * harm
                )
        if click_rate > 0:
            rms = np.sqrt(np.mean(x**2, axis=-1, keepdims=True))
            clicks = (
                rng.random((n_rows, L)) < click_rate / sample_rate
            ) * rng.standard_normal((n_rows, L))
            burst = np.exp(-np.arange(32, dtype=np.float32) * 0.2)
            x += 6.0 * rms * sps.fftconvolve(
                clicks, burst[None, :], mode="same", axes=-1
            )
        scenes[f"scene{s:02d}"] = [x[i].astype(np.float32) for i in range(n_rows)]

    ir_len_max = int(1.5 * sample_rate)
    irs = np.zeros((num_irs, ir_len_max), np.float32)
    for i in range(num_irs):
        t60 = float(np.exp(rng.uniform(np.log(0.1), np.log(1.2))))
        n_i = min(int(1.2 * t60 * sample_rate), ir_len_max)
        tt = np.arange(n_i, dtype=np.float32) / sample_rate
        late = rng.standard_normal(n_i).astype(np.float32) * np.exp(
            -(np.log(1000.0) / t60) * tt
        )
        early = np.zeros(n_i, np.float32)
        n_refl = int(rng.integers(3, 12))
        pos = rng.integers(1, max(2, int(0.05 * sample_rate)), n_refl)
        early[pos] = rng.uniform(0.2, 0.9, n_refl) * rng.choice(
            [-1.0, 1.0], n_refl
        )
        ir = 0.25 * late + early
        ir[0] = 1.0
        irs[i, :n_i] = ir
    noise_bank = build_noise_bank(scenes, sample_rate, row_length=L, seed=seed, device=device)
    ir_bank = build_ir_bank(irs, sample_rate, device=device)
    return noise_bank, ir_bank
