"""The UNet's dropout against Flax's: masks bit for bit at the five sites.

Flax's ``nn.Dropout(0.05)`` named ``Dropout_0`` .. ``Dropout_4`` (the
UNet's sites, in call order) draws ``bernoulli(fold(k_drop, "Dropout_i",
1), 0.95)`` over the NHWC activation. The port's plain version
(``models.dropout.dropout_plain``, what a CPU tensor takes) is held to it on
the sites' own shapes, in float32 and bfloat16, over the whole batch and
over each of two ranks' slices: the mask bit for bit and the values exactly
(unjitted Flax divides by the keep probability in the activation's type;
under ``jit`` XLA multiplies by its float32 reciprocal, an ulp away at
times). Then the UNet's training forward against the JAX UNet's in float64
on the same weights and key (within 1e-6 of the largest output: the JAX
UNet casts to float32 before its last 1x1 conv), its gradient, and the keyless training forward, which raises. The fused CUDA
kernel is held to the plain version in ``tests/test_torch_cuda.py`` and
``chip_smoke.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from musicfpaugment_torch.core import prng
from musicfpaugment_torch.models import UNet
from musicfpaugment_torch.models import dropout as tdrop
from musicfpaugment_tpu.models import UNet as JUNet

from torch_port_helpers import few_threads, flax_float32_dropout_masks, flax_unet_variables, port_unet  # noqa: F401

pytestmark = pytest.mark.usefixtures("few_threads")

RATE = 0.05
# NHWC shapes of the five sites of a base=4 UNet at (4, 33, 20): after
# down1 .. down4 and up1
SITES = [(4, 16, 10, 8), (4, 8, 5, 16), (4, 4, 2, 32), (4, 2, 1, 64), (4, 4, 2, 32)]
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


class FiveSites(fnn.Module):
    """Five Flax dropouts, ``Dropout_0`` .. ``Dropout_4``, one per input."""

    @fnn.compact
    def __call__(self, xs):
        return [fnn.Dropout(RATE, deterministic=False)(x) for x in xs]


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) + 0.5 for s in SITES]


def _jkey(key):
    return prng.as_key(np.asarray(jax.random.key_data(key)))


@pytest.fixture(scope="module")
def flax_sites():
    """Flax's outputs at the five sites, per dtype, as float32 NCHW."""
    xs = _inputs()
    k_drop = jax.random.fold_in(jax.random.PRNGKey(59), 3)
    out = {}
    for name, (jdt, _) in DTYPES.items():
        ys = FiveSites().apply({}, [jnp.asarray(x).astype(jdt) for x in xs], rngs={"dropout": k_drop})
        out[name] = [np.asarray(y.astype(jnp.float32)).transpose(0, 3, 1, 2) for y in ys]
    return xs, _jkey(k_drop), out


@pytest.mark.parametrize("slices", [1, 2], ids=["whole_batch", "two_ranks"])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_plain_masks_equal_flax_at_the_five_sites(flax_sites, dtype, slices):
    xs, key, want = flax_sites
    tdt = DTYPES[dtype][1]
    for i, (x, w) in enumerate(zip(xs, want[dtype])):
        site = tdrop.FlaxDropout(RATE, i).train()
        x_nchw = torch.from_numpy(x.transpose(0, 3, 1, 2).copy()).to(tdt)
        b = x.shape[0] // slices
        got = torch.cat([site(x_nchw[lo:lo + b], key, batch_offset=lo)
                         for lo in range(0, x.shape[0], b)]).float().numpy()
        assert got.dtype == np.float32 and got.shape == w.shape
        np.testing.assert_array_equal(got == 0, w == 0, err_msg=f"Dropout_{i}")
        np.testing.assert_array_equal(got, w, err_msg=f"Dropout_{i}")
        assert 0.0 < float(np.mean(w == 0)) < 0.2, i  # some dropped, most kept


def test_plain_gradient_is_the_masked_upstream_gradient():
    x = torch.randn(3, 8, 5, 7, dtype=torch.float64, requires_grad=True)
    key = prng.flax_fold(prng.key(4), "Dropout_2", 1)
    y = tdrop.dropout_plain(x, key, RATE, batch_offset=3)
    g = torch.randn_like(y)
    y.backward(g)
    mask = y.detach() != 0
    keep = torch.tensor(1 - RATE, dtype=torch.float64)
    assert torch.equal(x.grad, torch.where(mask, g / keep, torch.zeros((), dtype=torch.float64)))
    assert torch.equal(y.detach(), torch.where(mask, x.detach() / keep, torch.zeros((), dtype=torch.float64)))
    # the slice from counter 3 * H * W * C is rows 3.. of a batch of 6
    whole = tdrop.dropout_plain(torch.cat([torch.ones(3, 8, 5, 7), torch.ones(3, 8, 5, 7)]), key, RATE)
    assert torch.equal(whole[3:] != 0, mask)


def test_training_forward_needs_the_key_and_evaluation_does_not():
    x = torch.rand(2, 33, 20)
    model = UNet(1, 1, rate=RATE, base=4).train()
    with pytest.raises(ValueError, match="dropout key"):
        model(x)
    a = model(x, dropout_key=prng.key(1))
    b = model(x, dropout_key=prng.key(1))
    c = model(x, dropout_key=prng.key(2))
    assert torch.equal(a, b) and not torch.equal(a, c)
    model.eval()
    with torch.no_grad():
        assert torch.equal(model(x), model(x, dropout_key=prng.key(2)))
    UNet(1, 1, rate=0.0, base=4).train()(x)  # rate 0: no key needed


def test_cpu_tensors_take_the_plain_version_and_the_kernel_route_refuses_them(monkeypatch):
    x = torch.ones(1, 2, 3, 4)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        tdrop.dropout_cuda(x, prng.key(0), RATE)
    with pytest.raises(ValueError, match=r"\(B, C, H, W\)"):
        tdrop.dropout_plain(torch.ones(2, 3), prng.key(0), RATE)
    calls = []
    monkeypatch.setattr(tdrop, "dropout_plain", lambda *a: calls.append(a) or a[0])
    tdrop.dropout(x, prng.key(0), RATE, 5)
    assert len(calls) == 1 and calls[0][3] == 5
    assert tdrop.LAUNCHES["dropout_threefry"] == 0


@pytest.mark.parametrize("bilinear", [False, True], ids=["convT", "bilinear"])
def test_unet_training_forward_matches_flax_in_float64(bilinear):
    """The whole UNet in training mode, both packages in float64 on the same
    weights and dropout key (Flax's masks as drawn with x64 off): the
    output within 1e-6 of its largest value (the JAX UNet's last 1x1 conv is
    float32); the sites are in Flax's order."""
    jm = JUNet(1, 1, rate=RATE, base=4, bilinear=bilinear)
    params, stats = flax_unet_variables(jm, (1, 33, 20))
    x = np.random.default_rng(1).uniform(0.0, 1.0, (4, 33, 20))
    k_drop = jax.random.PRNGKey(17)
    with jax.enable_x64(True), flax_float32_dropout_masks():
        p64, s64 = (jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), t) for t in (params, stats))
        want, _ = jax.jit(lambda v, h: jm.apply(v, h, train=True, mutable=["batch_stats"],
                                                rngs={"dropout": k_drop}))(
            {"params": p64, "batch_stats": s64}, jnp.asarray(x))
        want = np.asarray(want)
    model = port_unet(params, stats, rate=RATE).double().train()
    undropped = port_unet(params, stats, rate=0.0).double().train()
    with torch.no_grad():
        got = model(torch.from_numpy(x), dropout_key=_jkey(k_drop)).numpy()
        kept_all = undropped(torch.from_numpy(x)).numpy()
    assert float(np.abs(got - want).max()) <= 1e-6 * float(np.abs(want).max())
    assert float(np.abs(got - kept_all).max()) > 1e-3 * float(np.abs(want).max())  # dropout acted
