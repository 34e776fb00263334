"""Port parity: musicfpaugment_torch.core.prng against jax.random.

Keys, ``split``, ``fold_in``, ``uniform``, ``randint`` and ``bernoulli`` are
held bit for bit against the JAX installed here (threefry, partitionable),
for several seeds, shapes, bounds and batches of keys (JAX's side is
``jax.vmap`` over the keys). ``normal`` evaluates XLA's float32 ``erf_inv``
polynomial over torch's ``log1p``: within 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from musicfpaugment_torch.core import prng

SEEDS = [0, 1, 42, 1234, 2**31 + 3]
SHAPES = [(), (1,), (7,), (3, 5), (1000,)]


def _bits(x):
    x = np.asarray(x)
    return x.view(np.uint32) if x.dtype == np.float32 else x


def _equal(got: torch.Tensor, want):
    want = np.asarray(want)
    got = got.numpy()
    assert got.shape == want.shape, (got.shape, want.shape)
    assert got.dtype == want.dtype or (want.dtype == np.uint32 and got.dtype == np.int64)
    np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("seed", SEEDS + [-1, 2**32 + 5, 2**40])
def test_key_matches_prngkey(seed):
    _equal(prng.key(seed), jax.random.PRNGKey(seed))
    assert prng.PRNGKey is prng.key


@pytest.mark.parametrize("num", [2, 5, (2, 3)])
@pytest.mark.parametrize("seed", SEEDS)
def test_split_matches_jax(seed, num):
    _equal(prng.split(prng.key(seed), num), jax.random.split(jax.random.PRNGKey(seed), num))


@pytest.mark.parametrize("data", [0, 1, 12345, 2**31, 2**32 - 1])
@pytest.mark.parametrize("seed", SEEDS)
def test_fold_in_matches_jax(seed, data):
    _equal(prng.fold_in(prng.key(seed), data), jax.random.fold_in(jax.random.PRNGKey(seed), data))


@pytest.mark.parametrize("bounds", [(0.0, 1.0), (-3.5, 80.25), (80.0, 3500.0), (0.3, 1.0), (5.0, 5.0)])
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("seed", SEEDS[:3])
def test_uniform_matches_jax_bit_for_bit(seed, shape, bounds):
    lo, hi = bounds
    want = jax.random.uniform(jax.random.PRNGKey(seed), shape, jnp.float32, lo, hi)
    _equal(prng.uniform(prng.key(seed), shape, lo, hi), want)


@pytest.mark.parametrize(
    "bounds", [(3, 64001), (0, 271), (0, 1), (5, 5), (-5, 2**31 - 1), (-(2**31), 2**31 - 1)])
@pytest.mark.parametrize("shape", SHAPES)
def test_randint_matches_jax(shape, bounds):
    for seed in SEEDS[:3]:
        want = jax.random.randint(jax.random.PRNGKey(seed), shape, *bounds)
        _equal(prng.randint(prng.key(seed), shape, *bounds), want)


@pytest.mark.parametrize("p", [0.0, 0.05, 0.5, 0.9, 1.0])
def test_bernoulli_matches_jax(p):
    for seed in SEEDS:
        for shape in SHAPES:
            want = jax.random.bernoulli(jax.random.PRNGKey(seed), p, shape)
            _equal(prng.bernoulli(prng.key(seed), p, shape), want)


@pytest.mark.parametrize("seed", SEEDS[:3])
def test_normal_within_1e_6_of_jax(seed):
    want = np.asarray(jax.random.normal(jax.random.PRNGKey(seed), (1 << 16,)))
    got = prng.normal(prng.key(seed), (1 << 16,)).numpy()
    assert got.dtype == np.float32
    assert float(np.abs(got - want).max()) <= 1e-6
    assert float(np.abs(want).max()) > 3.5  # the tails, where erfinv is steep, are in


def test_erfinv32_matches_xla_and_the_edges():
    x = prng.uniform(prng.key(5), (1 << 14,), -1.0, 1.0)
    want = np.asarray(jax.lax.erf_inv(jnp.asarray(x.numpy())))
    assert float(np.abs(prng.erfinv32(x).numpy() - want).max()) <= 5e-7
    edges = prng.erfinv32(torch.tensor([-1.0, 0.0, 1.0])).tolist()
    assert edges == [-float("inf"), 0.0, float("inf")]


def test_batched_keys_equal_jax_vmap():
    """Every function over a (4, 3, 2) batch of keys is JAX's vmapped."""
    jkeys = jax.random.split(jax.random.PRNGKey(3), (4, 3))
    tkeys = prng.split(prng.key(3), (4, 3))
    _equal(tkeys, jkeys)
    vv = lambda f: jax.vmap(jax.vmap(f))  # noqa: E731
    _equal(prng.split(tkeys, 2), vv(lambda k: jax.random.split(k, 2))(jkeys))
    data = jnp.arange(12, dtype=jnp.uint32).reshape(4, 3)
    _equal(prng.fold_in(tkeys, torch.arange(12).reshape(4, 3)),
           vv(jax.random.fold_in)(jkeys, data))
    _equal(prng.fold_in(tkeys, 9), vv(lambda k: jax.random.fold_in(k, 9))(jkeys))
    _equal(prng.uniform(tkeys, (5,), 1.0, 2.0),
           vv(lambda k: jax.random.uniform(k, (5,), jnp.float32, 1.0, 2.0))(jkeys))
    _equal(prng.randint(tkeys, (5,), 0, 271), vv(lambda k: jax.random.randint(k, (5,), 0, 271))(jkeys))
    _equal(prng.bernoulli(tkeys, 0.3, (5,)), vv(lambda k: jax.random.bernoulli(k, 0.3, (5,)))(jkeys))
    want = np.asarray(vv(lambda k: jax.random.normal(k, (5,)))(jkeys))
    assert float(np.abs(prng.normal(tkeys, (5,)).numpy() - want).max()) <= 1e-6


def test_keys_from_arrays_and_their_device():
    k = prng.as_key(np.asarray(jax.random.PRNGKey(7)))
    assert k.dtype == torch.int64 and torch.equal(k, prng.key(7))
    assert torch.equal(prng.as_key([0, 7]), prng.key(7))
    assert torch.equal(prng.as_key(torch.tensor([0, 7], dtype=torch.int32)), prng.key(7))
    # a key is its words: negative int32 views of them are the same key
    assert torch.equal(prng.as_key(torch.tensor([-1, 7])), torch.tensor([2**32 - 1, 7]))
    assert prng.uniform(prng.key(7), (3,)).device.type == "cpu"
    with pytest.raises(ValueError):
        prng.as_key(torch.zeros(3))


def test_draws_do_not_depend_on_their_batch():
    """The counter layout makes a batch of keys the rows of one key each:
    example i's draws do not depend on what else is drawn with it."""
    keys = prng.split(prng.key(11), 64)
    whole = prng.uniform(keys, (8,))
    parts = torch.cat([prng.uniform(keys[i : i + 5], (8,)) for i in range(0, 64, 5)])
    assert torch.equal(whole, parts)
    assert torch.equal(prng.uniform(keys[17], (8,)), whole[17])
