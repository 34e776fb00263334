"""The port's UNet against the Flax UNet on the same weights (CPU, base=8).

Weights come from ``model.init`` with batch statistics, scales and biases
redrawn from a numpy seed (``torch_port_helpers.flax_unet_variables``) and
cross to the port through ``convert.unet_state_dict_from_flax``. Tolerances,
relative to the largest output: eval 1e-5; a ``rate=0`` training forward 1e-5
(bilinear: 1e-4 of Flax and 1e-5 of the port's own float64 run, see the test)
and the running statistics after it 1e-5; bfloat16 compute 5e-2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from musicfpaugment_torch import convert
from musicfpaugment_torch.core import prng
from musicfpaugment_torch.models import UNet
from musicfpaugment_tpu.models import UNet as JUNet

from torch_port_helpers import few_threads, flax_unet_variables, make_identity_unet, port_unet, rel_err  # noqa: F401

pytestmark = pytest.mark.usefixtures("few_threads")

BASE = 8


@pytest.fixture(scope="module", params=[False, True], ids=["convT", "bilinear"])
def pair(request):
    """(bilinear, Flax model, params, batch_stats, port model in eval mode)."""
    jm = JUNet(1, 1, base=BASE, bilinear=request.param)
    params, stats = flax_unet_variables(jm, (1, 16, 16), seed=5)
    return request.param, jm, params, stats, port_unet(params, stats)


def _spectrogram(shape, seed):
    return np.random.default_rng(seed).uniform(0.0, 1.0, shape).astype(np.float32)


@pytest.mark.parametrize("shape", [(2, 257, 94), (1, 257, 251), (1, 16, 16), (2, 33, 47)])
def test_eval_output_matches_flax(pair, shape):
    _, jm, params, stats, tm = pair
    x = _spectrogram(shape, 1)
    want = np.asarray(jm.apply({"params": params, "batch_stats": stats}, jnp.asarray(x)))
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    assert got.dtype == np.float32 and got.shape == shape
    assert rel_err(got, want) <= 1e-5


@pytest.mark.parametrize("bilinear", [False, True])
def test_four_dim_input_keeps_its_channels(bilinear):
    """JAX takes (B, F, T, C), the port (B, C, F, T); 2 channels in, 3 out."""
    jm = JUNet(2, 3, base=BASE, bilinear=bilinear)
    params, stats = flax_unet_variables(jm, (1, 16, 16, 2), seed=6)
    tm = port_unet(params, stats)
    x = _spectrogram((2, 37, 29, 2), 2)
    want = np.asarray(jm.apply({"params": params, "batch_stats": stats}, jnp.asarray(x)))
    with torch.no_grad():
        got = tm(torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()
    assert got.shape == (2, 3, 37, 29)
    assert rel_err(got.transpose(0, 2, 3, 1), want) <= 1e-5
    # three dimensions with more than one class keep the class axis
    jm1 = JUNet(1, 2, base=BASE, bilinear=bilinear)
    p1, s1 = flax_unet_variables(jm1, (1, 16, 16), seed=7)
    with torch.no_grad():
        assert port_unet(p1, s1)(torch.zeros(1, 16, 16)).shape == (1, 2, 16, 16)


def test_training_forward_and_running_statistics_match_flax(pair):
    _, jm, params, stats, _ = pair
    tm = port_unet(params, stats).train()  # rate=0: no dropout draws to match
    x = _spectrogram((3, 65, 50), 3)
    want, updated = jm.apply(
        {"params": params, "batch_stats": stats}, jnp.asarray(x), train=True,
        mutable=["batch_stats"],
    )
    got = tm(torch.from_numpy(x)).detach().numpy()
    # Dividing by a batch's own deviation amplifies float32 rounding, and Flax
    # takes that variance as E[x^2] - E[x]^2: its output lies 6e-6 (transposed
    # conv) to 6e-5 (bilinear) from a float64 run of the same model, the port's
    # 1e-6 to 6e-6. So the port is held to 1e-5 of its own float64 run, and to
    # 1e-5 (transposed conv) or 1e-4 (bilinear) of Flax.
    exact = port_unet(params, stats).double().train()(torch.from_numpy(x).double())
    assert rel_err(got, exact.detach().numpy()) <= 1e-5
    assert rel_err(got, np.asarray(want)) <= (1e-4 if pair[0] else 1e-5)
    # Flax folds the biased batch variance into its average; so does the port
    after = convert.unet_state_dict_from_flax(
        params, jax.tree_util.tree_map(np.asarray, updated["batch_stats"]))
    state = tm.state_dict()
    moved = 0.0
    before = convert.unet_state_dict_from_flax(params, stats)
    for key, value in after.items():
        if "running_" in key:
            assert rel_err(state[key].numpy(), value.numpy()) <= 1e-5, key
            moved = max(moved, float((value - before[key]).abs().max()))
    assert moved > 1e-3
    assert int(state["inc.bn1.num_batches_tracked"]) == 1
    # PyTorch's own layer would have stored the unbiased variance
    bn = torch.nn.BatchNorm2d(4, momentum=0.1).train()
    flax_like = type(tm.inc.bn1)(4, momentum=0.1).train()
    y = torch.from_numpy(_spectrogram((2, 4, 3, 3), 4))
    bn(y), flax_like(y)
    n = 2 * 3 * 3
    torch.testing.assert_close(
        flax_like.running_var - 0.9, (bn.running_var - 0.9) * (n - 1) / n, rtol=1e-5, atol=1e-7)


def test_dropout_sits_after_the_four_downs_and_the_first_up():
    tm = UNet(1, 1, rate=0.5, base=4).train()
    seen = []
    for m in tm.dropouts:
        m.register_forward_hook(lambda mod, args, out: seen.append((mod.index, tuple(args[0].shape[1:]))))
    tm(torch.zeros(2, 32, 32), dropout_key=prng.key(1))
    assert seen == list(enumerate([(8, 16, 16), (16, 8, 8), (32, 4, 4), (64, 2, 2), (32, 4, 4)]))
    tm.eval()
    x = torch.rand(1, 32, 32)
    with torch.no_grad():
        assert torch.equal(tm(x), tm(x))


@pytest.mark.parametrize("bilinear", [False, True])
def test_channel_plan_at_base_64_matches_flax(bilinear):
    shapes = jax.eval_shape(
        lambda: JUNet(1, 1, bilinear=bilinear).init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32))))
    want = sum(int(np.prod(l.shape)) for l in jax.tree_util.tree_leaves(shapes["params"]))
    with torch.device("meta"):
        tm = UNet(1, 1, bilinear=bilinear)
    assert sum(p.numel() for p in tm.parameters()) == want
    assert want == (13_334_849 if bilinear else 31_036_481)
    assert tm.down4.conv.conv2.out_channels == (512 if bilinear else 1024)
    assert tm.up4.conv.conv1.in_channels == 128 and tm.outc.in_channels == 64
    if bilinear:
        assert tm.up1.conv.conv1.out_channels == 256  # mid = deep channels / 2
        assert not hasattr(tm.up1, "up")


def test_bfloat16_compute_matches_flax(pair):
    bilinear, _, params, stats, _ = pair
    jb = JUNet(1, 1, base=BASE, bilinear=bilinear, dtype=jnp.bfloat16)
    tb = port_unet(params, stats, dtype=torch.bfloat16)
    x = _spectrogram((2, 64, 48), 8)
    want = np.asarray(jb.apply({"params": params, "batch_stats": stats}, jnp.asarray(x)))
    with torch.no_grad():
        got = tb(torch.from_numpy(x))
    assert got.dtype == torch.float32 and want.dtype == np.float32
    assert all(p.dtype == torch.float32 for p in tb.parameters())
    assert rel_err(got.numpy(), want) <= 5e-2


def test_transposed_conv_kernel_is_flipped():
    """Flax's ConvTranspose correlates with the kernel as it stands;
    ``ConvTranspose2d`` flips it, so the converter flips it back."""
    layer = fnn.ConvTranspose(3, (2, 2), strides=(2, 2), padding="VALID")
    rng = np.random.default_rng(9)
    x = rng.standard_normal((2, 5, 4, 6)).astype(np.float32)
    kernel = rng.standard_normal((2, 2, 6, 3)).astype(np.float32)
    bias = rng.standard_normal(3).astype(np.float32)
    want = np.asarray(layer.apply({"params": {"kernel": kernel, "bias": bias}}, jnp.asarray(x)))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    flipped = torch.from_numpy(kernel[::-1, ::-1].transpose(2, 3, 0, 1).copy())
    unflipped = torch.from_numpy(kernel.transpose(2, 3, 0, 1).copy())
    b = torch.from_numpy(bias)
    got = torch.nn.functional.conv_transpose2d(xt, flipped, b, stride=2).permute(0, 2, 3, 1)
    off = torch.nn.functional.conv_transpose2d(xt, unflipped, b, stride=2).permute(0, 2, 3, 1)
    assert rel_err(got.numpy(), want) <= 1e-6
    assert rel_err(off.numpy(), want) > 0.1


def _without(tree, path):
    out = {k: (_without(v, path[1:]) if k == path[0] and len(path) > 1 else v)
           for k, v in tree.items() if not (k == path[0] and len(path) == 1)}
    return out


def _with(tree, path, value):
    out = dict(tree)
    out[path[0]] = value if len(path) == 1 else _with(tree.get(path[0], {}), path[1:], value)
    return out


@pytest.mark.parametrize("fault,match", [
    ("missing_kernel", "lack the leaf Down_2/DoubleConv_0/Conv_1/kernel"),
    ("missing_stat", "batch_stats lack the leaf Up_1/DoubleConv_0/BatchNorm_0/var"),
    ("missing_first", "lack the leaf DoubleConv_0/Conv_0/kernel"),
    ("surplus_param", "no use for"),
    ("surplus_stat", "no use for"),
    ("misshapen", "does not fit"),
    ("flat_kernel", "must be"),
])
def test_converter_raises_on_a_tree_that_does_not_fit(pair, fault, match):
    bilinear, _, params, stats, _ = pair
    if fault == "missing_kernel":
        params = _without(params, ["Down_2", "DoubleConv_0", "Conv_1", "kernel"])
    elif fault == "missing_stat":
        stats = _without(stats, ["Up_1", "DoubleConv_0", "BatchNorm_0", "var"])
    elif fault == "missing_first":
        params = _without(params, ["DoubleConv_0", "Conv_0", "kernel"])
    elif fault == "surplus_param":
        params = _with(params, ["Down_4", "DoubleConv_0", "Conv_0", "kernel"], np.zeros((3, 3, 1, 1), np.float32))
    elif fault == "surplus_stat":
        stats = _with(stats, ["DoubleConv_0", "BatchNorm_2", "mean"], np.zeros(8, np.float32))
    elif fault == "misshapen":
        params = _with(params, ["Up_2", "DoubleConv_0", "BatchNorm_1", "scale"], np.ones(5, np.float32))
    elif fault == "flat_kernel":
        params = _with(params, ["Down_0", "DoubleConv_0", "Conv_0", "kernel"], np.zeros(9, np.float32))
    with pytest.raises(ValueError, match=match):
        convert.unet_state_dict_from_flax(params, stats)


def test_converter_state_loads_strictly_for_other_widths():
    for base, bilinear in ((4, False), (12, True)):
        jm = JUNet(1, 1, base=base, bilinear=bilinear)
        params, stats = flax_unet_variables(jm, (1, 16, 16), seed=base)
        state = convert.unet_state_dict_from_flax(params, stats)
        tm = UNet(1, 1, base=base, bilinear=bilinear)
        assert set(state) == set(tm.state_dict())
        tm.load_state_dict(state, strict=True)
        with pytest.raises(RuntimeError):  # a model of another width refuses it
            UNet(1, 1, base=base + 4, bilinear=bilinear).load_state_dict(state, strict=True)


@pytest.mark.parametrize("shape", [(2, 257, 94), (1, 33, 47)])
def test_identity_weights_give_the_input_back(shape):
    tm = make_identity_unet(UNet(1, 1, base=BASE))
    x = torch.from_numpy(_spectrogram(shape, 10))
    out = convert.unet_denoiser(tm)(x)
    assert out.dtype == torch.float32 and out.shape == x.shape
    assert float((out - x).abs().max()) <= 1e-6
    # negative input is not passed: the ReLUs cut it
    assert float(convert.unet_denoiser(tm)(-x).abs().max()) == 0.0


def test_unet_denoiser_runs_in_eval_mode_without_grad(pair):
    _, _, params, stats, _ = pair
    tm = port_unet(params, stats).train()
    hook = convert.unet_denoiser(tm)
    assert not tm.training
    before = {k: v.clone() for k, v in tm.state_dict().items()}
    x = torch.from_numpy(_spectrogram((2, 40, 30), 11))
    out = hook(x)
    assert out.is_inference() and not out.requires_grad
    assert all(torch.equal(v, before[k]) for k, v in tm.state_dict().items())
    with torch.no_grad():
        assert torch.equal(out, tm(x))
