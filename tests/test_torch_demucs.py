"""The port's Demucs against the JAX package's on the same weights (CPU).

Flax weights drawn from a numpy seed go through
``convert.demucs_state_dict_from_flax``. Tolerances: eval forward and every
``stop_at`` milestone within 1e-5 of the largest output at small widths,
1e-4 at the published width (sums over 768 LSTM units and 1,536 channels);
``rescale_params`` 1e-6 of each tensor's largest value; bfloat16 compute
within 5e-2 of the float32 output (the JAX package's own limit).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from musicfpaugment_torch import convert
from musicfpaugment_torch.models import Demucs, rescale_params
from musicfpaugment_tpu.models import Demucs as JDemucs
from musicfpaugment_tpu.models import rescale_params as j_rescale_params

from torch_port_helpers import few_threads, flax_demucs_params, port_demucs, rel_err  # noqa: F401

pytestmark = pytest.mark.usefixtures("few_threads")

TOL = 1e-5
FULL_WIDTH_TOL = 1e-4
BF16_TOL = 5e-2

CASES = {
    "causal_d3": (dict(hidden=8, depth=3), (2, 3000)),
    "causal_d4_valid_length": (dict(hidden=8, depth=4), (2, 2133)),
    "bidirectional_d3": (dict(hidden=8, depth=3, causal=False), (2, 2500)),
    "two_channels": (dict(chin=2, chout=2, hidden=8, depth=3), (2, 2, 2100)),
    "unnormalised_resample2": (dict(hidden=8, depth=3, normalize=False, resample=2), (3, 1999)),
}
CONSTRUCTOR_ONLY = ("normalize", "resample")


def _input(shape, seed=0):
    return (0.3 * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _pair(case):
    """(JAX model, Flax params, port model) of one case."""
    kw, shape = CASES[case]
    jm = JDemucs(**kw)
    params = flax_demucs_params(jm, length=shape[-1], seed=len(case))
    return jm, params, port_demucs(params, **{k: v for k, v in kw.items() if k in CONSTRUCTOR_ONLY})


def _flax(jm, params, x, stop_at=None):
    fn = jax.jit(functools.partial(jm.apply, stop_at=stop_at))
    return np.asarray(fn({"params": params}, jnp.asarray(x)))


@pytest.mark.parametrize("case", list(CASES))
def test_eval_forward_matches_flax(case):
    jm, params, model = _pair(case)
    x = _input(CASES[case][1], seed=1)
    if case == "causal_d4_valid_length":
        assert jm.valid_length(x.shape[-1]) == x.shape[-1]
    else:
        assert jm.valid_length(x.shape[-1]) != x.shape[-1]
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    want = _flax(jm, params, x)
    assert got.dtype == torch.float32 and got.shape == want.shape == x.shape
    assert rel_err(got.numpy(), want) <= TOL


@pytest.mark.parametrize("stop_at", ["frontend", "enc1", "enc", "lstm", "dec"])
@pytest.mark.parametrize("case", ["causal_d3", "bidirectional_d3"])
def test_stop_at_milestones_match_flax(case, stop_at):
    """The port returns (B, C, T) where Flax returns (B, T, C)."""
    jm, params, model = _pair(case)
    x = _input(CASES[case][1], seed=2)
    with torch.no_grad():
        got = model(torch.from_numpy(x), stop_at=stop_at).numpy()
    want = _flax(jm, params, x, stop_at).transpose(0, 2, 1)
    assert rel_err(got, want) <= TOL


def test_published_width_matches_flax_on_a_one_second_clip():
    jm = JDemucs()
    params = flax_demucs_params(jm, length=8000, seed=48)
    model = port_demucs(params)
    assert sum(p.numel() for p in model.parameters()) == 18_867_937
    assert sum(a.size for a in jax.tree_util.tree_leaves(params)) == 18_861_793
    x = _input((1, 8000), seed=3)
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    assert rel_err(got, _flax(jm, params, x)) <= FULL_WIDTH_TOL


@pytest.mark.parametrize("kw", [{}, dict(hidden=8, depth=3), dict(depth=4, resample=2),
                                dict(depth=2, resample=1, kernel_size=6, stride=3)])
def test_valid_length_and_total_stride_match_jax(kw):
    jm, model = JDemucs(**kw), Demucs(**kw)
    assert model.total_stride == jm.total_stride
    assert model.channel_plan() == jm.channel_plan()
    for length in list(range(1, 400, 7)) + [8000, 24000, 64000, 64001]:
        assert model.valid_length(length) == jm.valid_length(length), length


def test_rescale_params_matches_jax():
    _, params, _ = _pair("bidirectional_d3")
    want = convert.demucs_state_dict_from_flax(
        jax.tree_util.tree_map(np.asarray, j_rescale_params(params, reference=0.1)))
    model = port_demucs(params)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    assert rescale_params(model, 0.1) is model
    for k, v in model.state_dict().items():
        assert rel_err(v.numpy(), want[k].numpy()) <= 1e-6, k
        if k.startswith("lstm."):
            assert torch.equal(v, before[k]), k  # the LSTM and the linear layer untouched
        else:
            assert not torch.equal(v, before[k]), k


@pytest.mark.parametrize("causal", [True, False])
def test_bfloat16_stays_near_float32_with_float32_parameters_and_output(causal):
    torch.manual_seed(5)
    m32 = Demucs(hidden=8, depth=3, causal=causal)
    mbf = Demucs(hidden=8, depth=3, causal=causal, dtype=torch.bfloat16)
    mbf.load_state_dict(m32.state_dict())
    x = torch.from_numpy(_input((2, 8000), seed=4))
    with torch.no_grad():
        y32, ybf = m32(x), mbf(x)
        inner = mbf(x, stop_at="enc")
    assert ybf.dtype == torch.float32 and inner.dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in mbf.parameters())
    assert rel_err(ybf.numpy(), y32.numpy()) <= BF16_TOL
    assert not torch.equal(ybf, y32)
    mbf(x).abs().mean().backward()
    grads = [p.grad for p in mbf.parameters()]
    assert all(g is not None and g.dtype == torch.float32 and torch.isfinite(g).all() for g in grads)


def test_forward_runs_with_cudnn_on_and_tf32_off():
    seen = []

    def record(*_):
        seen.append((torch.backends.cudnn.enabled, torch.backends.cudnn.allow_tf32))

    model = Demucs(hidden=8, depth=3)
    layers = [m for m in model.modules() if isinstance(m, (torch.nn.Conv1d, torch.nn.ConvTranspose1d,
                                                          torch.nn.LSTM))]
    for m in layers:
        m.register_forward_hook(record)
    assert torch.backends.cudnn.allow_tf32  # the default outside
    with torch.no_grad():
        model(torch.from_numpy(_input((1, 3000))))
    assert len(seen) == len(layers) and set(seen) == {(torch.backends.cudnn.enabled, False)}
    assert torch.backends.cudnn.allow_tf32


def test_state_dict_to_flax_round_trip_runs_in_flax():
    """A model trained here (both LSTM biases set) -> Flax leaves -> Flax
    forward equals the port's; back through the converter it is the same
    function, and its leaves convert to the same Flax tree again."""
    torch.manual_seed(6)
    for causal in (True, False):
        model = Demucs(hidden=8, depth=3, causal=causal).eval()
        with torch.no_grad():
            for name, p in model.lstm.lstm.named_parameters():
                if name.startswith("bias_hh"):
                    p.normal_(0.0, 0.1)
        tree = convert.demucs_state_dict_to_flax(model.state_dict())
        x = _input((2, 3000), seed=7)
        with torch.no_grad():
            want = model(torch.from_numpy(x)).numpy()
        assert rel_err(_flax(JDemucs(hidden=8, depth=3, causal=causal), tree, x), want) <= TOL
        back = port_demucs(tree)
        with torch.no_grad():
            assert rel_err(back(torch.from_numpy(x)).numpy(), want) <= TOL
        again = convert.demucs_state_dict_to_flax(back.state_dict())
        flat = lambda t: {jax.tree_util.keystr(k): v for k, v in jax.tree_util.tree_flatten_with_path(t)[0]}  # noqa: E731
        got, ref = flat(again), flat(tree)
        assert set(got) == set(ref)
        for k, v in ref.items():
            assert got[k].dtype == np.float32
            np.testing.assert_array_equal(got[k], v, err_msg=k)
    with pytest.raises(ValueError, match="no leaf"):
        convert.demucs_state_dict_to_flax(dict(model.state_dict(), extra=torch.zeros(1)))


def test_converter_raises_on_a_missing_surplus_or_misshapen_leaf():
    _, params, _ = _pair("causal_d3")

    def edited(fn):
        tree = jax.tree_util.tree_map(np.array, params)
        fn(tree)
        return tree

    cell = "OptimizedLSTMCell_1"
    with pytest.raises(ValueError, match="lack the leaf BLSTM_0/OptimizedLSTMCell_1/hg/kernel"):
        convert.demucs_state_dict_from_flax(edited(lambda t: t["BLSTM_0"][cell]["hg"].pop("kernel")))
    with pytest.raises(ValueError, match="no use for"):
        convert.demucs_state_dict_from_flax(edited(lambda t: t.update(Conv_99={"kernel": np.zeros((1, 1, 1))})))
    with pytest.raises(ValueError, match="does not fit"):
        convert.demucs_state_dict_from_flax(edited(
            lambda t: t["Conv_3"].update(kernel=np.zeros((1, 16, 31), np.float32))))
    with pytest.raises(ValueError, match="expected 3 dims"):
        convert.demucs_state_dict_from_flax(edited(
            lambda t: t["ConvTranspose_1"].update(kernel=np.zeros((8, 16), np.float32))))


def test_denoiser_hook_and_argument_checks():
    _, params, model = _pair("causal_d3")
    hook = convert.demucs_denoiser(model.train())
    x = torch.from_numpy(_input((3, 2000), seed=8))
    out = hook(x)
    assert not model.training and out.shape == x.shape and out.dtype == torch.float32
    assert not out.requires_grad
    assert rel_err(out.numpy(), model(x).detach().numpy()) <= 1e-6
    bf16 = Demucs(hidden=8, depth=3, dtype=torch.bfloat16)
    assert convert.demucs_denoiser(bf16)(x).dtype == torch.float32
    with pytest.raises(ValueError, match="stop_at"):
        model(x, stop_at="decoder")
    with pytest.raises(ValueError, match="resample"):
        Demucs(resample=3)
