"""Helpers shared by the port's augmentation tests.

The JAX package draws every random parameter inside its transforms from
threefry keys, which PyTorch cannot reproduce. These helpers recompute JAX's
own draws from a key with JAX's random functions, following the key tree of
the JAX transforms exactly, and hand them (as torch tensors) to the port's
deterministic ``apply`` functions. The JAX side of a comparison is then the
transform or the chain called with the same key.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from musicfpaugment_tpu.augment import transforms as JT

SR = 8000


def music(batch=4, samples=12000, seed=3, channels=None):
    """Deterministic band-limited multitone 'music', (B, T) or (B, C, T)."""
    rng = np.random.default_rng(seed)
    t = np.arange(samples) / SR
    shape = (batch, samples) if channels is None else (batch, channels, samples)
    out = np.zeros(shape, np.float32)
    for row in out.reshape(-1, samples):
        for f in rng.uniform(100, 3000, size=5):
            row += np.sin(2 * np.pi * f * t + rng.uniform(0, 6)).astype(np.float32)
    return 0.15 * out


def rel_err(got, want):
    """Largest difference over the reference's largest magnitude."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()), 1e-30)


def to_torch(draws):
    return {k: torch.from_numpy(np.array(v)) for k, v in draws.items()}


def jax_gate(key, p, batch):
    if p >= 1.0:
        return jnp.ones((batch,), bool)
    if p <= 0.0:
        return jnp.zeros((batch,), bool)
    return jax.random.bernoulli(key, p, (batch,))


def jax_noise_crop_draws(key, bank, batch, num_samples):
    """scene / row uniform / offset as ``NoiseBank.sample`` draws them."""
    k_scene, k_row, k_off = jax.random.split(key, 3)
    scene = jax.random.randint(k_scene, (batch,), 0, bank.scene_starts.shape[0])
    row_u = jax.random.uniform(k_row, (batch,))
    max_off = bank.row_length - num_samples
    if max_off <= 0:
        offset = jnp.zeros((batch,), jnp.int32)
    else:
        offset = jax.random.randint(k_off, (batch,), 0, max_off + 1)
    return {"scene": scene, "row_u": row_u, "offset": offset}


def jax_stage_draws(tfm, key, batch, num_samples, noise_bank=None, ir_bank=None, sr=SR):
    """The draws a JAX transform makes when called with ``key``, as a dict of
    torch tensors under the port's names."""
    k_mask, k_tfm = jax.random.split(key)
    d = {"mask": jax_gate(k_mask, tfm.p, batch)}
    if isinstance(tfm, JT.LowPassFilter):
        d["cutoff"] = tfm._sample_cutoffs(k_tfm, batch, sr)
    elif isinstance(tfm, JT.BandPassFilter):
        k_center, k_bw = jax.random.split(k_tfm)
        center = JT.convert_mels_to_frequencies(
            JT._uniform(k_center, batch, JT._hz_to_mel(tfm.min_center_frequency),
                        JT._hz_to_mel(tfm.max_center_frequency)))
        bw = JT._uniform(k_bw, batch, tfm.min_bandwidth_fraction, tfm.max_bandwidth_fraction)
        d["low"] = center * (1.0 - 0.5 * bw) / sr
        d["high"] = center * (1.0 + 0.5 * bw) / sr
    elif isinstance(tfm, JT.ApplyImpulseResponse):
        d["index"] = jax.random.randint(k_tfm, (batch,), 0, ir_bank.num_irs)
    elif isinstance(tfm, JT.AddBackgroundNoise):
        k_noise, k_snr = jax.random.split(k_tfm)
        if tfm.mixup:
            k1, k2 = jax.random.split(k_noise)
            d.update(jax_noise_crop_draws(k1, noise_bank, batch, num_samples))
            second = jax_noise_crop_draws(k2, noise_bank, batch, num_samples)
            d.update({k + "2": v for k, v in second.items()})
        else:
            d.update(jax_noise_crop_draws(k_noise, noise_bank, batch, num_samples))
        d["snr_db"] = JT._uniform(k_snr, batch, tfm.min_snr_in_db, tfm.max_snr_in_db)
    elif isinstance(tfm, JT.AddColoredNoise):
        k_noise, k_snr, k_decay = jax.random.split(k_tfm, 3)
        d["snr_db"] = JT._uniform(k_snr, batch, tfm.min_snr_in_db, tfm.max_snr_in_db)
        d["f_decay"] = JT._uniform(k_decay, batch, tfm.min_f_decay, tfm.max_f_decay)
        noise_sr = tfm.sample_rate or sr or 44100
        d["white"] = jnp.stack([
            jax.random.normal(k, (noise_sr,), dtype=jnp.float32)
            for k in jax.random.split(k_noise, batch)
        ])
    elif isinstance(tfm, JT.Gain):
        d["gain_db"] = JT._uniform(k_tfm, batch, tfm.min_gain_in_db, tfm.max_gain_in_db)
    elif isinstance(tfm, JT.Clipping):
        d["quantile"] = JT._uniform(
            k_tfm, batch, tfm.min_percentile_threshold, tfm.max_percentile_threshold)
    return to_torch(d)


def jax_chain_draws(augmenter, key, batch, num_samples):
    """The draws of ``AugmentFP.batch_augment(x, key=key)``: one key per
    stage of the chain that runs, split from ``key``."""
    pipeline = (
        augmenter._fast_pipeline if augmenter.fast_chain else augmenter.augmentation_pipeline
    )
    keys = jax.random.split(key, len(pipeline.transforms))
    return [
        jax_stage_draws(t, k, batch, num_samples, augmenter.noise_bank,
                        augmenter.ir_bank, augmenter.sample_rate)
        for t, k in zip(pipeline.transforms, keys)
    ]


def port_banks(noise_bank, ir_bank):
    """The port's banks (on the CPU) from the JAX banks' fields."""
    from musicfpaugment_torch import convert

    return (
        convert.noise_bank_from_arrays(
            np.asarray(noise_bank.clips), np.asarray(noise_bank.scene_starts),
            np.asarray(noise_bank.scene_counts), noise_bank.sample_rate, device="cpu"),
        convert.ir_bank_from_arrays(
            np.asarray(ir_bank.irs), np.asarray(ir_bank.lengths),
            ir_bank.sample_rate, device="cpu"),
    )
