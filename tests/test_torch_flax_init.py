"""The port's Flax initialisation against Flax's own ``model.init``.

``prng.flax_fold`` against Flax's ``_fold_in_static`` (bit for bit), the
samplers against ``jax.random`` / ``jax.nn.initializers`` (truncated normal
and ``lecun_normal`` within an ulp of the magnitude, 2.4e-7 at |x| <= 2
before the scale: ``erf_inv`` is XLA's polynomial in both, with FMAs
rounded alike but for a few elements; orthogonal within 1e-6: LAPACK's QR on
each side), then whole models leaf by leaf against ``init(PRNGKey(0))``:
each element within 1e-7 absolute or two float32 ulps of its value, whichever
is larger (the unscaled truncated normal agrees within an ulp, the scale's
product rounds once more; a Demucs kernel of fan-in 4 reaches 1.14, where an
ulp is 1.2e-7), and within 1e-6 for the LSTM's orthogonal kernels. Compared in
Flax's layout (``convert.*_to_flax``), so every leaf Flax makes is named and
none is missing. Last, the trainer and the CLIs start from these weights.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core.scope import _fold_in_static

from musicfpaugment_torch import convert
from musicfpaugment_torch.core import prng
from musicfpaugment_torch.models import Demucs, UNet, flax_init, rescale_params
from musicfpaugment_torch.models import streamer as tstreamer
from musicfpaugment_torch.models.flax_init import lecun_normal
from musicfpaugment_torch.train import generate_audios as tgen_audio
from musicfpaugment_torch.train.trainer import Trainer
from musicfpaugment_tpu.models import Demucs as JDemucs
from musicfpaugment_tpu.models import UNet as JUNet
from musicfpaugment_tpu.models.demucs import rescale_params as jrescale
from musicfpaugment_tpu.parallel import make_mesh
from musicfpaugment_tpu.train import trainer as jtrainer

from torch_port_helpers import few_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("few_threads")

ORTHOGONAL_ATOL = 1e-6
LEAF_ATOL = 1e-7


def _jkey(key):
    return np.asarray(jax.random.key_data(key))


def _flat(tree):
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _assert_leaves_match(got_tree, want_tree):
    """Leaf by leaf: the same names and shapes, each element within
    LEAF_ATOL or two ulps of its value (the LSTM's recurrent kernels within
    ORTHOGONAL_ATOL); the kernels are not 0."""
    got, want = _flat(got_tree), _flat(want_tree)
    assert set(got) == set(want)
    for name, w in want.items():
        assert got[name].shape == w.shape, name
        orthogonal = any(f"['h{g}']['kernel']" in name for g in "ifgo")
        atol = ORTHOGONAL_ATOL if orthogonal else LEAF_ATOL
        tol = np.maximum(atol, 2 * np.spacing(np.abs(w).astype(np.float32)))
        err = np.abs(got[name].astype(np.float64) - w)
        assert np.all(err <= tol), (name, float(err.max(initial=0.0)))
        if name.endswith("['kernel']"):
            assert float(np.abs(w).max()) > 0, name


@pytest.mark.parametrize("path", [
    ("Down_0", "DoubleConv_0", "Conv_0", 1), ("Dropout_4", 1), ("BLSTM_0", "OptimizedLSTMCell_3", "hg", 1),
    ("Conv_0", 2), ("x", 0, 255, 256, 2**40, "é")])
def test_flax_fold_is_flax_lazy_rng_fold(path):
    for seed in (0, 59):
        want = _jkey(_fold_in_static(jax.random.PRNGKey(seed), path))
        np.testing.assert_array_equal(prng.flax_fold(prng.key(seed), *path).numpy(), want)
    np.testing.assert_array_equal(prng.flax_fold(prng.key(3)).numpy(), prng.key(3).numpy())
    with pytest.raises(ValueError):
        prng.flax_fold(prng.key(0), 1.5)


@pytest.mark.parametrize("lower,upper,shape", [(-2.0, 2.0, (3, 3, 8, 16)), (-1.0, 3.0, (4096,))])
def test_truncated_normal_matches_jax(lower, upper, shape):
    key = jax.random.fold_in(jax.random.PRNGKey(0), 7)
    want = np.asarray(jax.random.truncated_normal(key, lower, upper, shape))
    got = prng.truncated_normal(prng.as_key(_jkey(key)), lower, upper, shape).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    assert float(np.abs(got - want).max()) <= 2.4e-7
    assert np.mean(got == want) > 0.95
    assert got.min() > lower and got.max() < upper


@pytest.mark.parametrize("n,m", [(16, 16), (24, 9), (5, 9)])
def test_orthogonal_matches_jax(n, m):
    key = jax.random.fold_in(jax.random.PRNGKey(1), n * m)
    want = np.asarray(jax.random.orthogonal(key, n, (), jnp.float32, m))
    got = prng.orthogonal(prng.as_key(_jkey(key)), n, m).numpy()
    assert got.shape == want.shape == (n, m)
    assert float(np.abs(got - want).max()) <= ORTHOGONAL_ATOL


@pytest.mark.parametrize("shape", [(3, 3, 8, 16), (2, 2, 64, 32), (8, 1, 4), (12, 20)])
def test_lecun_normal_matches_jax(shape):
    key = jax.random.fold_in(jax.random.PRNGKey(2), len(shape))
    want = np.asarray(jax.nn.initializers.lecun_normal()(key, shape, jnp.float32))
    got = lecun_normal(prng.as_key(_jkey(key)), shape).numpy()
    assert float(np.abs(got - want).max()) <= LEAF_ATOL


@pytest.mark.parametrize("bilinear", [False, True], ids=["convT", "bilinear"])
def test_unet_init_matches_flax_leaf_by_leaf(bilinear):
    variables = JUNet(1, 1, base=8, bilinear=bilinear).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 33, 20)), train=False)
    model = flax_init(UNet(1, 1, base=8, bilinear=bilinear))
    params, stats = convert.unet_state_dict_to_flax(model.state_dict())
    _assert_leaves_match({"params": params, "batch_stats": stats},
                         {"params": variables["params"], "batch_stats": variables["batch_stats"]})
    assert all(int(v) == 0 for k, v in model.state_dict().items() if "num_batches" in k)


@pytest.mark.parametrize("causal", [True, False], ids=["lstm", "blstm"])
def test_demucs_init_and_rescale_match_flax_leaf_by_leaf(causal):
    """``Demucs(hidden=4, depth=2)``: Flax's init, then the trainer's rescale
    on both sides (the LSTM cells' kernels under their own paths)."""
    params = JDemucs(hidden=4, depth=2, causal=causal).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 4000)))["params"]
    model = flax_init(Demucs(hidden=4, depth=2, causal=causal))
    _assert_leaves_match(convert.demucs_state_dict_to_flax(model.state_dict()), params)
    rescale_params(model, 0.1)
    _assert_leaves_match(convert.demucs_state_dict_to_flax(model.state_dict()), jrescale(params, 0.1))


def test_streamer_benchmark_starts_from_flax_init(monkeypatch, capsys):
    """The streamer demo's Demucs is the JAX demo's ``demucs.init(PRNGKey(0),
    x)`` (no rescale)."""
    seen = []

    class Capture(tstreamer.DemucsStreamer):
        def __init__(self, demucs, **kw):
            seen.append(demucs)
            super().__init__(demucs, **kw)

    monkeypatch.setattr(tstreamer, "DemucsStreamer", Capture)
    tstreamer._benchmark(["--device", "cpu", "--hidden", "4", "--depth", "3",
                          "--sample_rate", "8000", "--seconds", "0.5"])
    assert "delta batch/streaming" in capsys.readouterr().out
    params = JDemucs(hidden=4, depth=3, resample=4).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 4000)))["params"]
    _assert_leaves_match(convert.demucs_state_dict_to_flax(seen[0].state_dict()), params)


def test_generate_audios_random_model_is_flax_init(monkeypatch, tmp_path):
    """Without a checkpoint the demo's model gets Flax's initial weights
    (no rescale), as the JAX demo's ``model.init(PRNGKey(0), ...)``."""
    monkeypatch.setattr(tgen_audio, "Demucs", functools.partial(Demucs, hidden=4, depth=2))
    inits = []
    monkeypatch.setattr(tgen_audio, "flax_init", lambda m: inits.append(m) or flax_init(m))
    tgen_audio.main(["--model", "demucs", "--device", "cpu", "--seconds", "1",
                     "--out", str(tmp_path / "out"), "--checkpoint", str(tmp_path / "none")])
    params = JDemucs(hidden=4, depth=2).init(jax.random.PRNGKey(0), jnp.zeros((1, 4000)))["params"]
    assert len(inits) == 1
    _assert_leaves_match(convert.demucs_state_dict_to_flax(inits[0].state_dict()), params)


def _clean(batch=2, seconds=1):
    return np.random.default_rng(0).standard_normal((batch, 8000 * seconds)).astype(np.float32) * 0.1


@pytest.mark.parametrize("kind", ["spec", "audio"])
def test_fresh_trainer_model_is_the_jax_trainers_state(kind, tmp_path):
    """A fresh port ``Trainer`` holds ``convert(JAX Trainer.state)``: the
    UNet's parameters and statistics, the Demucs rescaled exactly once."""
    clean = _clean()
    it = iter(())
    if kind == "spec":
        jmodel, model = JUNet(1, 1, rate=0.05, base=8), UNet(1, 1, rate=0.05, base=8)
    else:
        jmodel, model = JDemucs(hidden=4, depth=2), Demucs(hidden=4, depth=2)
    with torch.no_grad():  # weights the trainer must overwrite
        for p in model.parameters():
            p.fill_(0.5)
    jt = jtrainer.Trainer(jmodel, it, 1, it, 1, 1e-3, 2, str(tmp_path / "jax"), input_type=kind,
                          mesh=make_mesh(1), example_batch=clean)
    tt = Trainer(model, it, 1, it, 1, 1e-3, 2, str(tmp_path / "port"), input_type=kind, device="cpu")
    state = tt.model.state_dict()
    if kind == "spec":
        got = dict(zip(("params", "batch_stats"), convert.unet_state_dict_to_flax(state)))
        want = {"params": jt.state.params, "batch_stats": jt.state.batch_stats}
    else:
        got, want = convert.demucs_state_dict_to_flax(state), jt.state.params
    _assert_leaves_match(got, jax.tree_util.tree_map(np.asarray, want))
