"""Waveform transforms as batched functions, draws apart from arithmetic
(port of musicfpaugment_tpu/augment/transforms.py).

Every transform computes its candidate output for the whole batch and
lane-selects with the per-example gate, so unselected lanes keep their input
bit for bit. Each transform is split in two:

* ``draw(key, batch, ...)`` returns the per-example parameters as a dict of
  small ``(B,)`` tensors: the gate ``mask`` and whatever the transform needs
  (cutoff, IR index, noise scene/row/offset, SNR, gain, clipping quantile).
  It follows the JAX transform's key tree (``k_mask, k_tfm = split(key)``,
  the gate a Bernoulli under ``k_mask``, the parameters under ``k_tfm``) with
  the threefry functions of ``core/prng.py``, so a key gives the JAX
  package's draws. ``key`` is one key for the whole batch, as the JAX
  transform's ``__call__`` takes it, or a ``(B, 2)`` batch of keys, one per
  example, each drawing as a batch of one (the JAX package's vmapped
  per-example chain).
* ``apply(samples, draws, ...)`` holds all the arithmetic and is
  deterministic. The draws may live on another device than the samples (they
  are a few scalars per example); ``apply`` moves them.

``__call__(key, samples, ...)`` is the JAX transform's call: draw, then
apply. All transforms take and return ``samples`` of shape (batch, channels,
time) or (batch, time), float32.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch

from portbench.ref.augment.banks import IRBank, NoiseBank, draw_shape
from portbench.ref.core import prng
from portbench.ref.core.convolve import fft_convolve
from portbench.ref.core.filters import (
    DEFAULT_HALF_SIZE_MAX,
    DEFAULT_ZEROS,
    bandpass_filter,
    bandstop_filter,
    conv_edge_valid,
    highpass_filter,
    lowpass_filter,
    lowpass_kernels,
)
from portbench.ref.core.noise import batch_colored_noise, white_noise
from portbench.ref.core.utils import (
    calculate_rms,
    convert_decibels_to_amplitude_ratio,
    convert_mels_to_frequencies,
)

Draws = Dict[str, torch.Tensor]


def _db_to_ratio(decibels: torch.Tensor, device) -> torch.Tensor:
    """dB -> float32 amplitude ratio on ``device``, through float64: see
    :func:`_mels_to_hz` (one example must not depend on its place in the
    batch)."""
    return convert_decibels_to_amplitude_ratio(decibels.to(device, torch.float64)).to(torch.float32)


def _hz_to_mel(f: float) -> float:
    """Mel conversion of a config-time bound, in python floats."""
    return 2595.0 * math.log10(1.0 + f / 700.0)


def _per_example(v: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """Reshape a (batch,) vector to broadcast over ``like``'s trailing axes,
    on ``like``'s device."""
    return v.to(like.device).reshape(v.shape[0], *([1] * (like.ndim - 1)))


def _apply_mask(mask: torch.Tensor, transformed: torch.Tensor, samples: torch.Tensor) -> torch.Tensor:
    """Per-example lane select."""
    return torch.where(_per_example(mask, samples), transformed, samples)


def _uniform(key: torch.Tensor, batch: int, lo: float, hi: float) -> torch.Tensor:
    """(batch,) float32 uniforms in [lo, hi) under ``key``; ``lo`` where
    hi <= lo (no draw)."""
    if hi <= lo:
        return torch.full((batch,), lo, dtype=torch.float32)
    return prng.uniform(key, draw_shape(key, batch), lo, hi).reshape(batch)


def _gate(key: torch.Tensor, p: float, batch: int) -> torch.Tensor:
    """The per-example Bernoulli(p) gate; all on for p >= 1, all off for
    p <= 0 (no draw)."""
    if p >= 1.0:
        return torch.ones((batch,), dtype=torch.bool)
    if p <= 0.0:
        return torch.zeros((batch,), dtype=torch.bool)
    return prng.bernoulli(key, p, draw_shape(key, batch)).reshape(batch)


def _mels_to_hz(mels: torch.Tensor) -> torch.Tensor:
    """float32 mels -> Hz in float64. Rounded once by the caller: a
    vectorised ``10 ** x`` may round an element by its place in the batch,
    which float32 would let through into the draw."""
    return convert_mels_to_frequencies(mels.to(torch.float64))


class BaseWaveformTransform:
    """Static config holder; ``draw`` makes the per-example parameters,
    ``apply`` is the deterministic arithmetic, ``__call__`` is both."""

    supports_multichannel = True
    requires_sample_rate = True

    def __init__(self, p: float = 0.5, sample_rate: Optional[int] = None):
        assert 0.0 <= p <= 1.0
        self.p = p
        self.sample_rate = sample_rate

    # ------------------------------------------------------------- draws

    def draw(
        self,
        key: torch.Tensor,
        batch: int,
        num_samples: int,
        sample_rate: Optional[int] = None,
        noise_bank: Optional[NoiseBank] = None,
        ir_bank: Optional[IRBank] = None,
    ) -> Draws:
        """The parameters of ``batch`` examples under ``key`` (one key, or
        one per example): the gate under the first half of its split, the
        transform's own draws under the second."""
        k_mask, k_tfm = prng.split(prng.as_key(key)).unbind(-2)
        draws = {"mask": _gate(k_mask, self.p, batch)}
        draws.update(
            self._parameters(
                k_tfm, batch, num_samples, sample_rate or self.sample_rate,
                noise_bank=noise_bank, ir_bank=ir_bank,
            )
        )
        return draws

    def _parameters(self, key, batch, num_samples, sample_rate, *, noise_bank=None, ir_bank=None) -> Draws:
        return {}

    # ------------------------------------------------------------- arithmetic

    def apply(
        self,
        samples: torch.Tensor,
        draws: Draws,
        sample_rate: Optional[int] = None,
        noise_bank: Optional[NoiseBank] = None,
        ir_bank: Optional[IRBank] = None,
    ) -> torch.Tensor:
        """Apply with per-example gating: compute the candidate for the whole
        batch and lane-select. Transforms whose identity can be expressed
        through their parameters (gain 1, cutoff 0, thresholds +-inf)
        override this: the same result bit for bit, fewer memory passes."""
        if self.p <= 0.0:
            return samples
        transformed = self.transform(
            samples, draws, sample_rate or self.sample_rate,
            noise_bank=noise_bank, ir_bank=ir_bank,
        )
        return _apply_mask(draws["mask"], transformed, samples)

    def transform(self, samples, draws, sample_rate, *, noise_bank=None, ir_bank=None):
        raise NotImplementedError

    def __call__(
        self,
        key: torch.Tensor,
        samples: torch.Tensor,
        sample_rate: Optional[int] = None,
        noise_bank: Optional[NoiseBank] = None,
        ir_bank: Optional[IRBank] = None,
    ) -> torch.Tensor:
        if samples.ndim not in (2, 3):
            raise RuntimeError(
                "expects [batch, channels, time] or the mono path [batch, time]"
            )
        if self.p <= 0.0:
            return samples
        draws = self.draw(
            key, samples.shape[0], samples.shape[-1], sample_rate,
            noise_bank=noise_bank, ir_bank=ir_bank,
        )
        return self.apply(samples, draws, sample_rate, noise_bank=noise_bank, ir_bank=ir_bank)


# ----------------------------------------------------------------- filters


class LowPassFilter(BaseWaveformTransform):
    """Low-pass with cutoff sampled uniformly in mel space. Draws:
    ``cutoff`` as a fraction of the sample rate."""

    _mode = "low"

    def __init__(
        self,
        min_cutoff_freq: float = 150.0,
        max_cutoff_freq: float = 7500.0,
        p: float = 0.5,
        sample_rate: Optional[int] = None,
        half_size_max: Optional[int] = None,
    ):
        super().__init__(p=p, sample_rate=sample_rate)
        if min_cutoff_freq > max_cutoff_freq:
            raise ValueError("min_cutoff_freq must not be greater than max_cutoff_freq")
        self.min_cutoff_freq = float(min_cutoff_freq)
        self.max_cutoff_freq = float(max_cutoff_freq)
        if half_size_max is None:
            # The widest kernel in range is at the smallest cutoff: julius
            # half_size = int(zeros / (f/sr) / 2), capped at the global max
            # and rounded up to a multiple of 16 taps. A zero lower bound is
            # capped at 2048: only the draws below zeros*sr/(2*2048)
            # (~7.8 Hz at 8 kHz) get a truncated kernel, and at those cutoffs
            # the high-pass is near-identity (documented divergence; pass
            # half_size_max explicitly for the full-width kernel).
            sr = sample_rate or 8000
            if self.min_cutoff_freq > 0:
                h = int(DEFAULT_ZEROS * sr / self.min_cutoff_freq / 2)
                half_size_max = min(DEFAULT_HALF_SIZE_MAX, max(16, -(-h // 16) * 16))
            else:
                half_size_max = min(DEFAULT_HALF_SIZE_MAX, 2048)
        self.half_size_max = half_size_max

    def cutoff_bounds_mel(self):
        """U(ceil(mel(min)), floor(mel(max))) is what the cutoff is drawn
        from, in mel."""
        return (
            float(math.ceil(_hz_to_mel(self.min_cutoff_freq))),
            float(math.floor(_hz_to_mel(self.max_cutoff_freq))),
        )

    def _parameters(self, key, batch, num_samples, sample_rate, *, noise_bank=None, ir_bank=None):
        lo, hi = self.cutoff_bounds_mel()
        mels = _uniform(key, batch, lo, hi)
        return {"cutoff": (_mels_to_hz(mels) / sample_rate).to(torch.float32)}

    def transform(self, samples, draws, sample_rate, *, noise_bank=None, ir_bank=None):
        fn = lowpass_filter if self._mode == "low" else highpass_filter
        return fn(samples, draws["cutoff"].to(samples.device), half_size_max=self.half_size_max)


class HighPassFilter(LowPassFilter):
    """High-pass = identity - low-pass."""

    _mode = "high"

    def __init__(
        self,
        min_cutoff_freq: float = 20.0,
        max_cutoff_freq: float = 2400.0,
        p: float = 0.5,
        sample_rate: Optional[int] = None,
        half_size_max: Optional[int] = None,
    ):
        super().__init__(
            min_cutoff_freq, max_cutoff_freq, p=p, sample_rate=sample_rate,
            half_size_max=half_size_max,
        )

    def gated_cutoffs(self, draws: Draws, device) -> torch.Tensor:
        """Cutoff 0 yields the all-zero julius kernel, so hpf = x - 0 = x:
        gating through the cutoff is exact and skips the full-size select."""
        cutoffs = draws["cutoff"].to(device, torch.float32)
        return torch.where(draws["mask"].to(device), cutoffs, 0.0)

    def apply(self, samples, draws, sample_rate=None, noise_bank=None, ir_bank=None):
        if self.p <= 0.0:
            return samples
        cutoffs = self.gated_cutoffs(draws, samples.device)
        return highpass_filter(samples, cutoffs, half_size_max=self.half_size_max)


class BandPassFilter(BaseWaveformTransform):
    """Band-pass with mel-uniform center + uniform bandwidth fraction. Draws:
    ``low`` and ``high`` cutoffs as fractions of the sample rate."""

    _complement = False

    def __init__(
        self,
        min_center_frequency: float = 200.0,
        max_center_frequency: float = 4000.0,
        min_bandwidth_fraction: float = 0.5,
        max_bandwidth_fraction: float = 1.99,
        p: float = 0.5,
        sample_rate: Optional[int] = None,
        half_size_max: int = DEFAULT_HALF_SIZE_MAX,
    ):
        super().__init__(p=p, sample_rate=sample_rate)
        if max_center_frequency < min_center_frequency:
            raise ValueError(
                f"max_center_frequency ({max_center_frequency}) should be larger than "
                f"min_center_frequency ({min_center_frequency})."
            )
        if min_bandwidth_fraction <= 0.0:
            raise ValueError("min_bandwidth_fraction must be a positive number")
        if max_bandwidth_fraction < min_bandwidth_fraction:
            raise ValueError(
                f"max_bandwidth_fraction ({max_bandwidth_fraction}) should be larger "
                f"than min_bandwidth_fraction ({min_bandwidth_fraction})."
            )
        if max_bandwidth_fraction >= 2.0:
            raise ValueError(
                f"max_bandwidth_fraction ({max_bandwidth_fraction}) should be smaller "
                f"than 2.0, since otherwise low_cut_frequency of the band can be "
                f"smaller than 0 Hz."
            )
        self.min_center_frequency = min_center_frequency
        self.max_center_frequency = max_center_frequency
        self.min_bandwidth_fraction = min_bandwidth_fraction
        self.max_bandwidth_fraction = max_bandwidth_fraction
        self.half_size_max = half_size_max

    def _parameters(self, key, batch, num_samples, sample_rate, *, noise_bank=None, ir_bank=None):
        k_center, k_bw = prng.split(key).unbind(-2)
        lo_mel = _hz_to_mel(self.min_center_frequency)
        hi_mel = _hz_to_mel(self.max_center_frequency)
        center = _mels_to_hz(_uniform(k_center, batch, lo_mel, hi_mel))
        bw = _uniform(
            k_bw, batch, self.min_bandwidth_fraction, self.max_bandwidth_fraction
        ).to(torch.float64)
        return {
            "low": (center * (1.0 - 0.5 * bw) / sample_rate).to(torch.float32),
            "high": (center * (1.0 + 0.5 * bw) / sample_rate).to(torch.float32),
        }

    def transform(self, samples, draws, sample_rate, *, noise_bank=None, ir_bank=None):
        fn = bandstop_filter if self._complement else bandpass_filter
        return fn(
            samples, draws["low"].to(samples.device), draws["high"].to(samples.device),
            half_size_max=self.half_size_max,
        )


class BandStopFilter(BandPassFilter):
    """Band-stop = identity - band-pass."""

    _complement = True


# ----------------------------------------------------------------- reverb


class ApplyImpulseResponse(BaseWaveformTransform):
    """Room reverb: random bank IR, FFT convolution, peak normalization.
    Draws: ``index`` into the :class:`IRBank`.

    The zero-padded tail of shorter IRs contributes nothing to the linear
    convolution, so results equal ragged per-example convolutions.
    """

    def __init__(
        self,
        ir_bank: Optional[IRBank] = None,
        sample_rate: Optional[int] = None,
        convolve_mode: str = "full",
        compensate_for_propagation_delay: bool = False,
        p: float = 0.5,
        normalize: bool = True,
    ):
        super().__init__(p=p, sample_rate=sample_rate)
        self.ir_bank = ir_bank
        self.convolve_mode = convolve_mode
        self.compensate_for_propagation_delay = compensate_for_propagation_delay
        # ``normalize=False`` skips the post-convolution peak normalization:
        # used by AugmentFP's fast chain, where the final PeakNormalization
        # makes every intermediate positive rescale a no-op (see pipeline.py).
        self.normalize = normalize

    def _bank(self, ir_bank: Optional[IRBank]) -> IRBank:
        bank = ir_bank if ir_bank is not None else self.ir_bank
        if bank is None:
            raise ValueError("ApplyImpulseResponse requires an IRBank")
        return bank

    def _parameters(self, key, batch, num_samples, sample_rate, *, noise_bank=None, ir_bank=None):
        return {"index": self._bank(ir_bank).draw(key, batch)}

    def transform(self, samples, draws, sample_rate, *, noise_bank=None, ir_bank=None):
        num_samples = samples.shape[-1]
        ir = self._bank(ir_bank).take(draws["index"])  # (B, L)
        ir_b = ir.reshape(ir.shape[0], *([1] * (samples.ndim - 2)), ir.shape[-1])
        convolved = fft_convolve(samples, ir_b, mode=self.convolve_mode)
        if self.normalize:
            # peak-normalize over the full convolution tail, before truncation
            peak = convolved.abs().amax(dim=-1, keepdim=True)
            convolved = convolved / torch.where(peak > 0, peak, 1.0)
        if self.compensate_for_propagation_delay:
            # per-example shifted slice of the convolution, starting at the
            # IR's loudest tap (clamped so that the slice fits)
            delays = ir.abs().argmax(dim=-1)
            delays = torch.clamp(delays, max=max(convolved.shape[-1] - num_samples, 0))
            cols = _per_example(delays, convolved) + torch.arange(
                num_samples, device=samples.device
            )
            return torch.gather(convolved, -1, cols.expand(*convolved.shape[:-1], -1))
        return convolved[..., :num_samples]


# ----------------------------------------------------------------- noise


def _mix_at_snr(samples: torch.Tensor, noise: torch.Tensor, snr_db: torch.Tensor, normalize: bool):
    """samples + noise scaled to ``rms(samples) / 10**(snr/20)``; then the
    peak normalization, unless it is elided."""
    batch, num_samples = samples.shape[0], samples.shape[-1]
    ratio = _db_to_ratio(snr_db, samples.device).reshape(batch, *([1] * (samples.ndim - 2)))
    noise_rms = calculate_rms(samples) / ratio
    nz = noise.reshape(batch, *([1] * (samples.ndim - 2)), num_samples)
    mixed = samples + noise_rms[..., None] * nz
    if not normalize:
        return mixed
    peak = mixed.abs().amax(dim=-1, keepdim=True)
    return mixed / torch.where(peak > 0, peak, 1.0)


class AddBackgroundNoise(BaseWaveformTransform):
    """SNR-controlled scene-noise mixing from a :class:`NoiseBank`. Draws:
    ``scene``, ``row_u``, ``offset`` of the crop (and ``scene2``, ``row_u2``,
    ``offset2`` with mixup) and ``snr_db``."""

    def __init__(
        self,
        noise_bank: Optional[NoiseBank] = None,
        min_snr_in_db: float = 3.0,
        max_snr_in_db: float = 30.0,
        p: float = 0.5,
        sample_rate: Optional[int] = None,
        mixup: bool = False,
        normalize: bool = True,
    ):
        super().__init__(p=p, sample_rate=sample_rate)
        if min_snr_in_db > max_snr_in_db:
            raise ValueError("min_snr_in_db must not be greater than max_snr_in_db")
        self.noise_bank = noise_bank
        self.min_snr_in_db = float(min_snr_in_db)
        self.max_snr_in_db = float(max_snr_in_db)
        self.mixup = mixup
        # see ApplyImpulseResponse.normalize: fast-chain scale elision
        self.normalize = normalize

    def _bank(self, noise_bank: Optional[NoiseBank]) -> NoiseBank:
        bank = noise_bank if noise_bank is not None else self.noise_bank
        if bank is None:
            raise ValueError("AddBackgroundNoise requires a NoiseBank")
        return bank

    def _parameters(self, key, batch, num_samples, sample_rate, *, noise_bank=None, ir_bank=None):
        bank = self._bank(noise_bank)
        k_noise, k_snr = prng.split(key).unbind(-2)
        if self.mixup:
            k1, k2 = prng.split(k_noise).unbind(-2)
            draws = bank.draw(k1, batch, num_samples)
            second = bank.draw(k2, batch, num_samples)
            draws.update({k + "2": v for k, v in second.items()})
        else:
            draws = bank.draw(k_noise, batch, num_samples)
        draws["snr_db"] = _uniform(k_snr, batch, self.min_snr_in_db, self.max_snr_in_db)
        return draws

    def transform(self, samples, draws, sample_rate, *, noise_bank=None, ir_bank=None):
        bank = self._bank(noise_bank)
        num_samples = samples.shape[-1]
        first = {k: draws[k] for k in ("scene", "row_u", "offset")}
        if self.mixup:
            second = {k: draws[k + "2"] for k in first}
            background = bank.crop_pair(first, second, num_samples)
        else:
            background = bank.crop(**first, num_samples=num_samples)
        return _mix_at_snr(samples, background, draws["snr_db"], self.normalize)


class AddColoredNoise(BaseWaveformTransform):
    """1/f^decay noise at random SNR. Draws: ``snr_db``, ``f_decay`` and the
    one second of ``white`` noise per example that is shaped and tiled. Not
    in the default chain."""

    def __init__(
        self,
        min_snr_in_db: float = 3.0,
        max_snr_in_db: float = 30.0,
        min_f_decay: float = -2.0,
        max_f_decay: float = 2.0,
        p: float = 0.5,
        sample_rate: Optional[int] = None,
    ):
        super().__init__(p=p, sample_rate=sample_rate)
        if min_snr_in_db > max_snr_in_db:
            raise ValueError("min_snr_in_db must not be greater than max_snr_in_db")
        if min_f_decay > max_f_decay:
            raise ValueError("min_f_decay must not be greater than max_f_decay")
        self.min_snr_in_db = float(min_snr_in_db)
        self.max_snr_in_db = float(max_snr_in_db)
        self.min_f_decay = float(min_f_decay)
        self.max_f_decay = float(max_f_decay)

    def _parameters(self, key, batch, num_samples, sample_rate, *, noise_bank=None, ir_bank=None):
        k_noise, k_snr, k_decay = prng.split(key, 3).unbind(-2)
        sr = self.sample_rate or sample_rate or 44100
        return {
            "snr_db": _uniform(k_snr, batch, self.min_snr_in_db, self.max_snr_in_db),
            "f_decay": _uniform(k_decay, batch, self.min_f_decay, self.max_f_decay),
            "white": white_noise(k_noise, batch, sr),
        }

    def transform(self, samples, draws, sample_rate, *, noise_bank=None, ir_bank=None):
        sr = self.sample_rate or sample_rate or 44100
        noise = batch_colored_noise(
            None, draws["f_decay"].to(samples.device), samples.shape[-1], sr,
            white=draws["white"],
        )
        return _mix_at_snr(samples, noise, draws["snr_db"], True)


# ----------------------------------------------------------------- amplitude


class Gain(BaseWaveformTransform):
    """Random uniform dB gain. Draws: ``gain_db``."""

    requires_sample_rate = False

    def __init__(
        self,
        min_gain_in_db: float = -18.0,
        max_gain_in_db: float = 6.0,
        p: float = 0.5,
        sample_rate: Optional[int] = None,
    ):
        super().__init__(p=p, sample_rate=sample_rate)
        if min_gain_in_db >= max_gain_in_db:
            raise ValueError("max_gain_in_db must be higher than min_gain_in_db")
        self.min_gain_in_db = float(min_gain_in_db)
        self.max_gain_in_db = float(max_gain_in_db)

    def _parameters(self, key, batch, num_samples, sample_rate, *, noise_bank=None, ir_bank=None):
        return {"gain_db": _uniform(key, batch, self.min_gain_in_db, self.max_gain_in_db)}

    def transform(self, samples, draws, sample_rate, *, noise_bank=None, ir_bank=None):
        return samples * _per_example(_db_to_ratio(draws["gain_db"], samples.device), samples)

    def apply(self, samples, draws, sample_rate=None, noise_bank=None, ir_bank=None):
        # gate through the ratio: x * 1 == x exactly
        if self.p <= 0.0:
            return samples
        ratio = torch.where(
            draws["mask"].to(samples.device),
            _db_to_ratio(draws["gain_db"], samples.device),
            1.0,
        )
        return samples * _per_example(ratio, samples)


class Clipping(BaseWaveformTransform):
    """Percentile clipping. Draws: ``quantile`` q; samples below the
    (q/2)-th or above the (1-q/2)-th percentile are clipped.

    The percentiles are per example by default; ``batch_quantile=True``
    takes them over the whole batch flattened, which couples the examples
    (the behaviour of the original torch code).

    The order statistics come from a sort of each row (exact values, as the
    JAX package's key-space search gives); the interpolation between them
    is that of ``torch.quantile``.
    """

    requires_sample_rate = False

    def __init__(
        self,
        min_percentile_threshold: float = 0.0,
        max_percentile_threshold: float = 1.0,
        p: float = 0.5,
        sample_rate: Optional[int] = None,
        batch_quantile: bool = False,
    ):
        super().__init__(p=p, sample_rate=sample_rate)
        assert 0 <= min_percentile_threshold
        assert 1 >= max_percentile_threshold
        assert min_percentile_threshold <= max_percentile_threshold
        if min_percentile_threshold >= max_percentile_threshold:
            raise ValueError(
                "max_percentile_threshold must be higher than min_percentile_threshold"
            )
        self.min_percentile_threshold = float(min_percentile_threshold)
        self.max_percentile_threshold = float(max_percentile_threshold)
        self.batch_quantile = batch_quantile

    @staticmethod
    def _interp_quantile(sorted_vals: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
        """torch.quantile's linear interpolation at (B,) quantiles of
        pre-sorted values, (n,) shared by all or (B, n) one row each."""
        n = sorted_vals.shape[-1]
        pos = q * (n - 1)
        lo = torch.clamp(torch.floor(pos).to(torch.int64), 0, n - 2)
        frac = pos - lo.to(pos.dtype)
        if sorted_vals.ndim == 1:
            v_lo, v_hi = sorted_vals[lo], sorted_vals[lo + 1]
        else:
            v_lo = torch.gather(sorted_vals, -1, lo[:, None])[:, 0]
            v_hi = torch.gather(sorted_vals, -1, (lo + 1)[:, None])[:, 0]
        return v_lo * (1.0 - frac) + v_hi * frac

    def _parameters(self, key, batch, num_samples, sample_rate, *, noise_bank=None, ir_bank=None):
        return {
            "quantile": _uniform(
                key, batch, self.min_percentile_threshold, self.max_percentile_threshold
            )
        }

    def thresholds(self, draws: Draws, samples: torch.Tensor):
        """(lower, upper) clipping thresholds, (B,) each."""
        lower_q = draws["quantile"].to(samples.device, torch.float32) / 2.0
        ch0 = samples[:, 0, :] if samples.ndim == 3 else samples
        if self.batch_quantile:
            ordered = torch.sort(ch0.reshape(-1)).values
        else:
            ordered = torch.sort(ch0, dim=-1).values
        lower = self._interp_quantile(ordered, lower_q)
        upper = self._interp_quantile(ordered, 1.0 - lower_q)
        return lower, upper

    def transform(self, samples, draws, sample_rate, *, noise_bank=None, ir_bank=None):
        lower, upper = self.thresholds(draws, samples)
        return torch.clamp(samples, _per_example(lower, samples), _per_example(upper, samples))

    def apply(self, samples, draws, sample_rate=None, noise_bank=None, ir_bank=None):
        # gate through the thresholds: clamp(x, -inf, +inf) == x exactly
        if self.p <= 0.0:
            return samples
        lower, upper = self.thresholds(draws, samples)
        mask = draws["mask"].to(samples.device)
        lower = torch.where(mask, lower, -math.inf)
        upper = torch.where(mask, upper, math.inf)
        return torch.clamp(samples, _per_example(lower, samples), _per_example(upper, samples))


class Identity(BaseWaveformTransform):
    """No-op placeholder that keeps a chain's draw layout intact.

    AugmentFP's fast chain replaces Gain with this: a per-example scalar
    multiply is erased by the final PeakNormalization, but the stage still
    takes its key of the chain's split so that the frozen-seed stream
    matches the exact chain stage for stage. Its draws are the gate alone.
    """

    requires_sample_rate = False

    def apply(self, samples, draws, sample_rate=None, noise_bank=None, ir_bank=None):
        return samples

    def __call__(self, key, samples, sample_rate=None, noise_bank=None, ir_bank=None):
        return samples


class PeakNormalization(BaseWaveformTransform):
    """Scale so the per-example peak hits 0 dBFS; all-zero snippets
    untouched."""

    requires_sample_rate = False

    def transform(self, samples, draws, sample_rate, *, noise_bank=None, ir_bank=None):
        # per-example extreme over channels and time
        axes = tuple(range(1, samples.ndim))
        peak = samples.abs().amax(dim=axes, keepdim=True)
        return torch.where(peak > 0, samples / torch.where(peak > 0, peak, 1.0), samples)


# ----------------------------------------------------------------- LTI fusion


def fused_highpass_ir(
    samples: torch.Tensor,
    draws_hpf: Draws,
    draws_ir: Draws,
    hpf: HighPassFilter,
    ir_bank: IRBank,
) -> torch.Tensor:
    """HPF1 and the IR reverb as ONE convolution pass (fast chain).

    Both stages are LTI per example, so their cascade is a single
    convolution by the combined kernel ``(delta - k_lp) * ir``: one pass over
    the signal instead of two. The draws are the two stages' own, so the
    frozen-seed stream is that of the unfused chain; outputs differ from the
    unfused cascade only by float rounding (convolution associativity).
    Examples with both gates off return bit-exact passthrough, as unfused.
    Mono (B, T) only.

    Valid under the fast chain only, where the IR stage's peak normalization
    is elided.
    """
    B, T = samples.shape
    dev = samples.device
    H1 = hpf.half_size_max
    cutoffs = hpf.gated_cutoffs(draws_hpf, dev)
    mask_ir = draws_ir["mask"].to(dev)
    ir = ir_bank.take(draws_ir["index"])  # (B, L)
    L = ir.shape[-1]
    delta_ir = torch.zeros((L,), dtype=samples.dtype, device=dev)
    delta_ir[0] = 1.0
    ir_eff = torch.where(mask_ir[:, None], ir, delta_ir[None, :])
    # combined kernel: highpass (delta at center - k_lp) convolved with ir
    k_hp = -lowpass_kernels(cutoffs, H1)  # (B, 2*H1+1); cutoff<=0 -> zeros
    k_hp[:, H1] += 1.0
    k_comb = fft_convolve(k_hp, ir_eff, mode="full")  # (B, 2*H1+L)
    # one pass. Replicate padding by H1 reproduces the HPF edge behavior;
    # slicing [2*H1 : 2*H1+T] composes the HPF 'valid' slice with the IR
    # stage's causal [:T] truncation exactly.
    pad_x = torch.nn.functional.pad(samples[:, None, :], (H1, H1), mode="replicate")[:, 0, :]
    y = fft_convolve(pad_x, k_comb, mode="full")[..., 2 * H1 : 2 * H1 + T].clone()
    # left-edge correction. The unfused chain truncates the HPF output to
    # [0, T) BEFORE the IR conv, so the IR sees zeros there; the fused pass
    # instead convolves the HPF's (pad-region) tail at negative times into
    # the first L-1 outputs. Subtract that contamination: the convolution of
    # the HPF full-result over [-(L-1), 0) with the IR.
    if L > 1:
        lead = L - 1
        seg = pad_x[..., : 2 * H1]  # covers every sample the tail needs
        full_s = fft_convolve(seg, k_hp, mode="full")
        # hpf at t in [-(L-1), 0); tail positions before -(2*H1) are exact
        # zeros in both formulations, so an IR longer than the HPF pad window
        # left-fills with zeros
        take = min(lead, 2 * H1)
        w = full_s[..., 2 * H1 - take : 2 * H1]
        if take < lead:
            w = torch.nn.functional.pad(w, (lead - take, 0))
        corr = fft_convolve(w, ir_eff, mode="full")[..., lead : 2 * lead]
        y[..., :lead] -= corr
    # bit-exact passthrough where both gates are off
    off = (cutoffs <= 0.0) & ~mask_ir
    return torch.where(off[:, None], samples, y)


def fused_lowpass_highpass(
    samples: torch.Tensor,
    draws_lpf: Draws,
    draws_hpf: Draws,
    lpf: LowPassFilter,
    hpf: HighPassFilter,
) -> torch.Tensor:
    """LPF2 and HPF3 (the chain's trailing filter pair) as ONE conv pass.

    The cascade is one convolution by the combined kernel
    ``e_l * (delta - k_h)`` where ``e_l`` is the low-pass kernel (or delta
    for gated-off lanes) and ``k_h`` the high-pass's low-pass part (cutoff 0
    for gated-off lanes).

    BOTH stages replicate-pad their own input, and stage 2 pads the stage-1
    output, so a plain fused conv gets every sample within ``E = H_l + H_h``
    of either edge wrong. The interior comes from the fused kernel, and the
    two ``E``-sample edge regions are recomputed stage by stage on short
    slices (length ``2E``), which is exact because a valid conv only reads
    ``H`` neighbours. Inputs of ``T <= 2E`` run the stages. Mono (B, T) only.
    """
    B, T = samples.shape
    dev = samples.device
    Hl, Hh = lpf.half_size_max, hpf.half_size_max
    E = Hl + Hh
    mask_l = draws_lpf["mask"].to(dev)
    c_l = draws_lpf["cutoff"].to(dev, torch.float32)
    c_h = hpf.gated_cutoffs(draws_hpf, dev)
    # effective kernels
    k_l = lowpass_kernels(c_l, Hl)  # (B, 2*Hl+1)
    delta_l = torch.zeros((2 * Hl + 1,), dtype=samples.dtype, device=dev)
    delta_l[Hl] = 1.0
    e_l = torch.where(mask_l[:, None], k_l, delta_l[None, :])
    k_h = lowpass_kernels(c_h, Hh)  # rows are exact zeros when cutoff <= 0

    def staged(x):
        y = conv_edge_valid(x, e_l, Hl)
        return y - conv_edge_valid(y, k_h, Hh)

    if T <= 2 * E:
        z = staged(samples)
    else:
        d_h = -k_h
        d_h[:, Hh] += 1.0  # delta - k_h
        k_c = fft_convolve(e_l, d_h, mode="full")  # (B, 2E+1)
        z = conv_edge_valid(samples, k_c, E).clone()
        # exact staged edges on 2E-sample slices. Left: y values feeding
        # kept outputs are y[0 : E+Hh), whose windows end at x[2E-1], inside
        # the slice; the HPF's left replicate pad sees the true y[0]. Right:
        # mirrored.
        yl = conv_edge_valid(samples[:, : 2 * E], e_l, Hl)[:, : E + Hh]
        zl = yl - conv_edge_valid(yl, k_h, Hh)
        zr = staged(samples[:, T - 2 * E :])
        z[:, :E] = zl[:, :E]
        z[:, T - E :] = zr[:, -E:]
    # bit-exact passthrough where both gates are off, as unfused
    off = ~mask_l & (c_h <= 0.0)
    return torch.where(off[:, None], samples, z)


__all__ = [
    "BaseWaveformTransform",
    "LowPassFilter",
    "HighPassFilter",
    "BandPassFilter",
    "BandStopFilter",
    "ApplyImpulseResponse",
    "AddBackgroundNoise",
    "AddColoredNoise",
    "Gain",
    "Clipping",
    "Identity",
    "PeakNormalization",
    "fused_highpass_ir",
    "fused_lowpass_highpass",
]
