"""Three training steps of the port's ``Trainer`` against the JAX package's,
each from its own initialisation, in float64 (CPU, batch 4, 1 s clips).

Both trainers are built fresh from the same seed: the port's draws Flax's
initial weights itself (``models.flax_init``, equal to JAX's ``init`` within
an ulp or two) and, at ``rate=0.05``, the UNet's dropout masks under the
second half of each step key, as the JAX trainer does. The JAX side runs
its own ``_loss_terms`` and optax's Adam in float64 (``jax.enable_x64``),
with Flax's masks as drawn with x64 off (``flax_float32_dropout_masks``);
the port's trainer runs its model in float64. After each step, to the
tolerances of ``tests/test_torch_trainer.py``'s float64 step:

- "spec" (the UNet): loss within 1e-5 relative; gradients within 1e-4 of
  each tensor's largest value; running statistics within 1e-5 of their
  largest value; weights within lr / 30 where the gradient is above ten
  times its error at every step so far (Adam moves an element whose
  gradient is at the level of its rounding by +-lr either way), with what
  that leaves out counted (at most 1%);
- "audio" (Demucs, no dropout: the initialisation and the steps): loss
  terms within 1e-5 relative, gradients within 1e-4 of each tensor's
  largest value, every weight within lr / 100.

One difference of layout is modelled, not hidden: ``nn.LSTM`` carries two
biases per gate where Flax's cell carries one, and each of the two takes its
own Adam step (the original reference's layout, kept since the port's
Demucs was written). The JAX reference of the "audio" case therefore trains a
zero copy of each gate bias beside it, added to it in the forward pass, so
both runs train the same parameterisation; the copy is held to ``bias_hh``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as fnn

from musicfpaugment_torch import convert
from musicfpaugment_torch.data.synthetic import synthetic_clean_batches
from musicfpaugment_torch.models import Demucs, UNet
from musicfpaugment_torch.train.trainer import Trainer
from musicfpaugment_tpu.models import Demucs as JDemucs
from musicfpaugment_tpu.models import UNet as JUNet
from musicfpaugment_tpu.parallel import make_mesh
from musicfpaugment_tpu.train import trainer as jtrainer

from torch_port_helpers import few_threads, flax_float32_dropout_masks  # noqa: F401

pytestmark = pytest.mark.usefixtures("few_threads")

SR = 8000
BATCH = 4
LR = 1e-3
STEPS = 3
SEED = 59


def _batches(seed):
    clean = synthetic_clean_batches(BATCH, SR, SR, seed=seed)
    r = np.random.default_rng(seed)
    out = []
    for _ in range(STEPS):
        c = next(clean)
        out.append((c, (0.7 * c + 0.2 * r.standard_normal(c.shape)).astype(np.float32)))
    return out


def _bias_copies(p):
    """A zero copy of every LSTM gate bias ({cell: {gate: bias}}; none for
    the UNet): the second bias of ``nn.LSTM``."""
    cells = p.get("BLSTM_0", {})
    return {c: {g: jnp.zeros_like(leaf["bias"]) for g, leaf in cells[c].items() if "bias" in leaf}
            for c in cells if c.startswith("OptimizedLSTMCell_")}


def _with_copies(p, copies):
    """Flax's parameters with each gate bias plus its copy."""
    if not copies:
        return p
    blstm = dict(p["BLSTM_0"])
    for c, gates in copies.items():
        blstm[c] = {g: dict(leaf, bias=leaf["bias"] + gates[g]) if g in gates else leaf
                    for g, leaf in blstm[c].items()}
    return dict(p, BLSTM_0=blstm)


def _jax_float64_steps(jt, batches):
    """The JAX trainer's steps in float64 from its own initial state: per
    step (loss terms, gradients, (parameters, bias copies), batch
    statistics) as numpy."""
    adam = optax.adam(LR, b1=0.9, b2=0.999)

    def step(pc, s, opt, clean, aug, k_drop):
        (_, (terms, new_s, _, _)), g = jax.value_and_grad(
            lambda q: jt._loss_terms(_with_copies(*q), s, clean, aug, k_drop, True), has_aux=True)(pc)
        updates, opt = adam.update(g, opt, pc)
        return optax.apply_updates(pc, updates), new_s, opt, terms, g[0]

    to_np = lambda t: jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), t)  # noqa: E731
    out = []
    with jax.enable_x64(True), flax_float32_dropout_masks():
        f64 = lambda t: jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), t)  # noqa: E731
        p, s = f64(jt.state.params), f64(jt.state.batch_stats)
        p = (p, _bias_copies(p))
        opt = adam.init(p)
        step = jax.jit(step)
        key = jax.random.PRNGKey(SEED)
        for clean, aug in batches:
            key, k = jax.random.split(key)  # the JAX trainer's _next_keys
            _, k_drop = jax.random.split(k)
            p, s, opt, terms, g = step(p, s, opt, jnp.asarray(clean, jnp.float64),
                                       jnp.asarray(aug, jnp.float64), k_drop)
            out.append((to_np(terms), to_np(g), to_np(p), to_np(s)))
    return out


def _port_steps(tt, batches):
    out = []
    for clean, aug in batches:
        terms = tt.train_step(torch.from_numpy(clean).double(), torch.from_numpy(aug).double())
        out.append(({k: float(v) for k, v in terms.items()},
                    {k: p.grad.clone() for k, p in tt.model.named_parameters()},
                    {k: v.clone() for k, v in tt.model.state_dict().items()}))
    return out


def _unet_float64(params, stats):
    """Flax UNet leaves (float64) in the port's layout, kept in float64: each
    leaf goes through the float32 converter as two float32 parts."""
    hi = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), (params, stats))
    lo = jax.tree_util.tree_map(lambda a, h: np.asarray(a - h, np.float32), (params, stats), hi)
    hi, lo = convert.unet_state_dict_from_flax(*hi), convert.unet_state_dict_from_flax(*lo)
    return {k: hi[k].double() + lo[k].double() for k in hi if "num_batches" not in k}


def _demucs_float64(params, copies=None):
    """As :func:`_unet_float64` for Demucs: each gate's Flax bias as
    ``bias_ih``, its copy as ``bias_hh`` (``copies`` None: the bias'
    gradient, which both of nn.LSTM's biases take)."""
    hi = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), params)
    lo = jax.tree_util.tree_map(lambda a, h: np.asarray(a - h, np.float32), params, hi)
    hi, lo = convert.demucs_state_dict_from_flax(hi), convert.demucs_state_dict_from_flax(lo)
    out = {k: hi[k].double() + lo[k].double() for k in hi}
    layers = sum(k.startswith("lstm.lstm.weight_ih_l") and "reverse" not in k for k in out)
    for cell, suffix in convert._lstm_cells(layers, "lstm.linear.weight" in out):
        c = cell.split("/")[1]
        out[f"lstm.lstm.bias_hh{suffix}"] = (
            out[f"lstm.lstm.bias_ih{suffix}"] if copies is None else
            torch.from_numpy(np.concatenate([np.asarray(copies[c][f"h{g}"], np.float64) for g in "ifgo"])))
    return out


def _grads_in_port_layout(kind, g, s):
    if kind == "spec":
        return {k: v for k, v in _unet_float64(g, s).items() if "running_" not in k}
    return _demucs_float64(g)


@pytest.fixture(scope="module")
def trajectories(tmp_path_factory):
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MFPA_STFT_MATMUL", "0")
        for kind, jmodel, model in (
                ("spec", JUNet(1, 1, rate=0.05, base=8), UNet(1, 1, rate=0.05, base=8)),
                ("audio", JDemucs(hidden=4, depth=2), Demucs(hidden=4, depth=2))):
            tmp = tmp_path_factory.mktemp(kind)
            batches = _batches(11 if kind == "spec" else 12)
            it = iter(())
            jt = jtrainer.Trainer(jmodel, it, 1, it, 1, LR, 2, str(tmp / "jax"), input_type=kind,
                                  mesh=make_mesh(1), example_batch=batches[0][0], seed=SEED)
            tt = Trainer(model.double(), it, 1, it, 1, LR, 2, str(tmp / "port"), input_type=kind,
                         device="cpu", seed=SEED)
            # Flax starts an LSTM carry in float32, which a float64 scan refuses
            init_carry = fnn.OptimizedLSTMCell.initialize_carry
            mp.setattr(fnn.OptimizedLSTMCell, "initialize_carry", lambda cell, rng, shape: tuple(
                c.astype(jnp.float64) for c in init_carry(cell, rng, shape)))
            want = _jax_float64_steps(jt, batches)
            mp.setattr(fnn.OptimizedLSTMCell, "initialize_carry", init_carry)
            out[kind] = (want, _port_steps(tt, batches))
    return out


def _check_loss_and_grads(kind, step, j, t):
    j_terms, j_g, _, j_s = j
    t_terms, t_g, _ = t
    assert set(t_terms) == set(j_terms)
    for k, v in j_terms.items():
        assert abs(t_terms[k] - v) <= 1e-5 * abs(v), (step, k, t_terms[k], v)
    want_g = _grads_in_port_layout(kind, j_g, j_s)
    errors = {}
    for k, w in want_g.items():
        err, top = float((t_g[k] - w).abs().max()), float(w.abs().max())
        assert top > 0 and err <= 1e-4 * top, (step, k, err, top)
        errors[k] = err
    return want_g, errors


def test_spec_trajectory_follows_jax_with_dropout(trajectories):
    want, got = trajectories["spec"]
    strong = None
    for step, (j, t) in enumerate(zip(want, got)):
        want_g, errors = _check_loss_and_grads("spec", step, j, t)
        now = {k: w.abs() > 10 * errors[k] for k, w in want_g.items()}
        strong = now if strong is None else {k: strong[k] & now[k] for k in now}
        j_params = _unet_float64(j[2][0], j[3])
        t_state = t[2]
        left_out = total = 0
        for k, w in j_params.items():
            if "running_" in k:
                assert float((t_state[k] - w).abs().max()) <= 1e-5 * float(w.abs().max()), (step, k)
                continue
            left_out += int((~strong[k]).sum())
            total += strong[k].numel()
            diff = (t_state[k] - w)[strong[k]].abs()
            assert float(diff.max()) <= LR / 30 if diff.numel() else True, (step, k)
        assert left_out <= 0.01 * total, (step, left_out, total)


def test_audio_trajectory_follows_jax_from_flax_init(trajectories):
    want, got = trajectories["audio"]
    for step, (j, t) in enumerate(zip(want, got)):
        _check_loss_and_grads("audio", step, j, t)
        for k, w in _demucs_float64(*j[2]).items():
            assert float((t[2][k] - w).abs().max()) <= LR / 100, (step, k)
