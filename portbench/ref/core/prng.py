"""The part of ``jax.random`` that the JAX package draws from: threefry-2x32
keys, ``split``, ``fold_in`` and the ``uniform``, ``randint``, ``bernoulli``,
``normal``, ``truncated_normal`` and ``orthogonal`` samplers, as plain tensor
functions; and Flax's fold of a module path into a key (``flax_fold``).

Bits follow JAX's partitionable threefry (``jax_threefry_partitionable``,
the default since JAX 0.5): a key is two 32-bit words; ``split(key, n)``
hashes the 64-bit counters ``0 .. n-1`` (high word, low word) and keeps both
output words as the new keys; ``fold_in(key, d)`` hashes the counter ``d``;
``n`` random words hash the counters ``0 .. n-1`` and xor the two output
words. The hash is 20 rounds of add, rotate and xor, so the same key gives
the same bits on every device.

A key is a ``(..., 2)`` int64 tensor holding unsigned 32-bit words (a
leading batch of keys is allowed everywhere: the samplers return
``(*keys.shape[:-1], *shape)``). ``uniform`` and ``bernoulli`` are bit for
bit JAX's; ``randint`` too; ``normal`` evaluates XLA's float32 ``erf_inv``
polynomial over a correctly rounded ``log1p``, so it agrees with JAX to an
ulp or two and is the same on every device; ``truncated_normal`` likewise.
``orthogonal`` takes a QR of normal draws, LAPACK's or the device
library's, so it agrees with JAX to ~1e-7, not to the bit. Every sampler
runs on the device of its key.
"""

from __future__ import annotations

import hashlib
import math
from typing import Sequence, Tuple, Union

import torch

from portbench.ref.device import DeviceLike

Shape = Union[int, Sequence[int]]

MASK32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_KS_PARITY = 0x1BD11BDA


def _shape(shape: Shape) -> Tuple[int, ...]:
    return (int(shape),) if isinstance(shape, int) else tuple(int(s) for s in shape)


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & MASK32) | (x >> (32 - r))


def threefry2x32(k0: torch.Tensor, k1: torch.Tensor, x0: torch.Tensor, x1: torch.Tensor):
    """The Threefry-2x32 hash of the counter words (x0, x1) under the key
    words (k0, k1); all int64 holding 32-bit words, broadcast together."""
    ks = (k0, k1, k0 ^ k1 ^ _KS_PARITY)
    x0 = (x0 + ks[0]) & MASK32
    x1 = (x1 + ks[1]) & MASK32
    for block in range(5):
        for r in _ROTATIONS[block % 2]:
            x0 = (x0 + x1) & MASK32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(block + 1) % 3]) & MASK32
        x1 = (x1 + ks[(block + 2) % 3] + block + 1) & MASK32
    return x0, x1


def key(seed: int, device: DeviceLike = "cpu") -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` with 32-bit integers (JAX's default):
    the words ``(0, seed mod 2**32)``."""
    return torch.tensor([0, int(seed) & MASK32], dtype=torch.int64, device=device)


PRNGKey = key


def as_key(k, device: DeviceLike = None) -> torch.Tensor:
    """A key (or a batch of keys) from a tensor, an array or a list of
    words; ``device`` None keeps a tensor where it is (else the CPU)."""
    if isinstance(k, torch.Tensor):
        out = k.to(torch.int64) if device is None else k.to(device, torch.int64)
    else:
        import numpy as np

        out = torch.from_numpy(np.asarray(k).astype(np.int64)).to(device or "cpu")
    if out.shape[-1:] != (2,):
        raise ValueError(f"a key is (..., 2) words, got shape {tuple(out.shape)}")
    return out & MASK32


def _counters(shape: Tuple[int, ...], device, offset: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """The 64-bit iota over ``shape``, from ``offset``, as (high word, low
    word)."""
    n = math.prod(shape)
    flat = torch.arange(offset, offset + n, dtype=torch.int64, device=device).reshape(shape)
    return flat >> 32, flat & MASK32


def _hash(keys: torch.Tensor, shape: Tuple[int, ...], offset: int = 0):
    """Both output words of the hash of ``shape``'s counters (from
    ``offset``) under every key: (*keys.shape[:-1], *shape) each."""
    keys = as_key(keys)
    hi, lo = _counters(shape, keys.device, offset)
    lead = keys.shape[:-1]
    view = lead + (1,) * len(shape)
    k0 = keys[..., 0].reshape(view)
    k1 = keys[..., 1].reshape(view)
    return threefry2x32(k0, k1, hi, lo)


def split(keys: torch.Tensor, num: Shape = 2) -> torch.Tensor:
    """``jax.random.split``: (..., 2) -> (..., *num, 2)."""
    b0, b1 = _hash(keys, _shape(num))
    return torch.stack([b0, b1], dim=-1)


def fold_in(keys: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in`` of the 32-bit ``data`` (an int, or a tensor
    broadcasting against the keys' batch: one key per element)."""
    keys = as_key(keys)
    d = torch.as_tensor(data, dtype=torch.int64, device=keys.device) & MASK32
    b0, b1 = threefry2x32(keys[..., 0], keys[..., 1], torch.zeros_like(d), d)
    return torch.stack(torch.broadcast_tensors(b0, b1), dim=-1)


def flax_fold(keys: torch.Tensor, *path: Union[str, int]) -> torch.Tensor:
    """Flax's ``LazyRng`` fold of static data into a key: the SHA-1 of the
    strings (UTF-8) and ints (big-endian, fewest bytes) of ``path`` one
    after another, whose first 4 bytes are ``fold_in``. A module's
    parameter ``n`` (in creation order, from 1) under ``model.init(key)``
    takes ``flax_fold(key, *module_path, n)``; ``make_rng("dropout")`` in
    a module takes ``flax_fold(key, *module_path, 1)`` at its first call."""
    if not path:
        return as_key(keys)
    m = hashlib.sha1()
    for x in path:
        if isinstance(x, str):
            m.update(x.encode("utf-8"))
        elif isinstance(x, int) and x >= 0:
            m.update(x.to_bytes((x.bit_length() + 7) // 8, byteorder="big"))
        else:
            raise ValueError(f"expected a string or a non-negative int, got {x!r}")
    return fold_in(keys, int.from_bytes(m.digest()[:4], byteorder="big"))


def random_bits(keys: torch.Tensor, shape: Shape, offset: int = 0) -> torch.Tensor:
    """32 random bits per element, (..., *shape) int64. ``offset`` > 0
    gives the elements ``offset ..`` of a larger draw (its flat index)."""
    b0, b1 = _hash(keys, _shape(shape), offset)
    return b0 ^ b1


def _f32(v, device) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.float32, device=device)


def uniform(keys: torch.Tensor, shape: Shape = (), minval=0.0, maxval=1.0, offset: int = 0) -> torch.Tensor:
    """``jax.random.uniform`` in float32: the top 23 bits as the mantissa
    of a float in [1, 2), minus 1, scaled to [minval, maxval).

    XLA contracts the scaling ``u * (maxval - minval) + minval`` into one
    fused multiply-add. The product of two float32 values is exact in
    float64, so the float64 sum rounded to float32 is that FMA (a double
    rounding could differ once in ~2**28 draws). ``offset`` as in
    :func:`random_bits`."""
    bits = random_bits(keys, shape, offset)
    one = (bits >> 9) | 0x3F800000
    floats = one.to(torch.int32).view(torch.float32) - 1.0
    lo = _f32(minval, floats.device)
    span = _f32(maxval, floats.device) - lo
    scaled = (floats.double() * span.double() + lo.double()).to(torch.float32)
    return torch.maximum(lo, scaled)


def bernoulli(keys: torch.Tensor, p: float = 0.5, shape: Shape = (), offset: int = 0) -> torch.Tensor:
    """``jax.random.bernoulli`` (mode "low"): uniform < p in float32, as JAX
    draws it with x64 off. ``offset`` as in :func:`random_bits`."""
    u = uniform(keys, shape, offset=offset)
    return u < _f32(p, u.device)


def randint(keys: torch.Tensor, shape: Shape, minval: int, maxval: int) -> torch.Tensor:
    """``jax.random.randint`` to int32: two words per element from the two
    halves of a split, reduced modulo the span in 32-bit arithmetic."""
    k1, k2 = split(keys).unbind(-2)
    higher, lower = random_bits(k1, shape), random_bits(k2, shape)
    lo = max(int(minval), -(2**31))
    hi = min(int(maxval), 2**31 - 1)
    span = 1 if hi <= lo else (hi - lo) & MASK32
    multiplier = (((2**16 % span) ** 2) & MASK32) % span
    offset = ((higher % span) * multiplier) & MASK32
    offset = ((offset + lower % span) & MASK32) % span
    out = (lo + offset) & MASK32
    return torch.where(out >= 2**31, out - 2**32, out).to(torch.int32)


# Giles' single-precision erfinv, the polynomial XLA evaluates for float32
# (w = -log1p(-x^2); below 5 in w - 2.5, else in sqrt(w) - 3)
_ERFINV_W_LT_5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
                  0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_W_GE_5 = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
                  0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)


def erfinv32(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 ``erf_inv``: Horner steps as fused multiply-adds
    (float64 sums of exact products, rounded to float32), as XLA's CPU
    backend contracts them; +-inf at +-1. ``log1p`` is taken in float64
    and rounded, so that every device gives the same float32 (a float32
    ``log1p`` is the device library's, and reads ulps apart)."""
    x = x.to(torch.float32)
    w = -torch.log1p((x * -x).double()).float()
    small = w < 5.0
    w = torch.where(small, w - 2.5, torch.sqrt(w) - 3.0).double()
    coef = [
        torch.where(small, _f32(a, x.device), _f32(b, x.device)).double()
        for a, b in zip(_ERFINV_W_LT_5, _ERFINV_W_GE_5)
    ]
    p = coef[0].float()
    for c in coef[1:]:
        p = (c + p.double() * w).float()
    return torch.where(x.abs() == 1.0, x * math.inf, p * x)


def normal(keys: torch.Tensor, shape: Shape = ()) -> torch.Tensor:
    """``jax.random.normal`` in float32: sqrt(2) erfinv(u), u uniform in
    (-1, 1); within an ulp or two of JAX's, whose ``log1p`` rounds as
    XLA's does."""
    lo = torch.nextafter(torch.tensor(-1.0), torch.tensor(0.0)).item()
    u = uniform(keys, shape, lo, 1.0)
    return _f32(math.sqrt(2), u.device) * erfinv32(u)


def _round32(v: float) -> float:
    return float(torch.tensor(v, dtype=torch.float32))


def truncated_normal(keys: torch.Tensor, lower: float, upper: float, shape: Shape = ()) -> torch.Tensor:
    """``jax.random.truncated_normal`` in float32: uniform between
    ``erf(lower / sqrt 2)`` and ``erf(upper / sqrt 2)`` (each correctly
    rounded, which XLA's float32 ``erf`` gives at the bounds Flax uses),
    ``sqrt(2) erfinv``, clipped to the open interval."""
    sqrt2 = _round32(math.sqrt(2))
    lo, hi = _round32(lower), _round32(upper)
    a, b = (_round32(math.erf(_round32(v / sqrt2))) for v in (lo, hi))
    u = uniform(keys, shape, a, b)
    out = _f32(sqrt2, u.device) * erfinv32(u)
    inside = torch.nextafter(_f32([lo, hi], "cpu"), _f32([math.inf, -math.inf], "cpu")).tolist()
    return out.clamp(*inside)


def orthogonal(keys: torch.Tensor, n: int, m: int = None) -> torch.Tensor:
    """``jax.random.orthogonal(key, n, (), float32, m)``: an (n, m) matrix
    with orthonormal columns (rows, if n < m), the Q of the QR of normal
    draws with the signs of R's diagonal folded in. One key."""
    m = n if m is None else m
    z = normal(keys, (max(n, m), min(n, m)))
    q, r = torch.linalg.qr(z)
    q = q * torch.sign(torch.diagonal(r, dim1=-2, dim2=-1)).unsqueeze(-2)
    return q.mT if n < m else q


__all__ = [
    "PRNGKey",
    "as_key",
    "bernoulli",
    "erfinv32",
    "flax_fold",
    "fold_in",
    "key",
    "normal",
    "orthogonal",
    "randint",
    "random_bits",
    "split",
    "threefry2x32",
    "truncated_normal",
    "uniform",
]
