"""The port's trainer against the JAX package's (CPU, ``base=8``, batch 4,
1 s clips).

Both trainers start from one state: the JAX trainer's ``params`` and
``batch_stats`` go through ``convert.unet_state_dict_from_flax``, both see
the same (clean, augmented) batches (``augmenter=None``, iterators of
tuples), and the UNet has ``rate=0`` (Flax's and torch's dropout masks
cannot match). Tolerances:

- loss, validation terms and the scheduler's best within 1e-5 relative;
- running statistics after the step within 1e-5 of the largest value;
- gradients within 1e-4 of each tensor's largest value from JAX's gradient
  taken in float64 (measured: 1.4e-5). JAX's float32 gradient is no
  reference: Flax takes the batch variance as E[x^2] - E[x]^2 (ROADMAP.md
  section 3), which at the deepest level of these 1 s clips (BatchNorm over
  4 x 16 x 2 values) puts it up to 1e-1 of the largest value from float64;
- updated weights: optax.adam (lr 1e-3) on that float64 gradient against
  the port's step, within lr / 30 where |g| exceeds ten times the tensor's
  measured gradient error e. Adam's first step is ``lr * g / (|g| + eps)``,
  which moves by at most ``lr * eps * e / (|g| - e + eps)^2 <= lr / 36``
  there; elements whose gradient is at the level of the rounding may flip
  sign and differ by 2 lr. The test counts what the mask leaves out;
- validation after the step on JAX's updated weights (the port's differ
  where the signs flipped).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import optax
import torch
from flax import linen as fnn

from musicfpaugment_torch import convert
from musicfpaugment_torch.augment import AugmentFP, synthetic_banks
from musicfpaugment_torch.data.synthetic import synthetic_clean_batches
from musicfpaugment_torch.models import UNet
from musicfpaugment_torch.train import train as ttrain
from musicfpaugment_torch.train.trainer import EarlyStopping, ReduceLROnPlateau, Trainer
from musicfpaugment_tpu.models import UNet as JUNet
from musicfpaugment_tpu.parallel import make_mesh
from musicfpaugment_tpu.train import trainer as jtrainer

from torch_port_helpers import few_threads, rel_err  # noqa: F401

pytestmark = pytest.mark.usefixtures("few_threads")

SR = 8000
BATCH = 4
LR = 1e-3
META_KEYS = {"epoch", "best_val_loss", "scheduler", "early_stopping"}


def _pairs(seed, n=4):
    """n (clean, augmented) batches of 1 s clips."""
    clean = synthetic_clean_batches(BATCH, SR, SR, seed=seed)
    r = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        c = next(clean)
        out.append((c, (0.7 * c + 0.2 * r.standard_normal(c.shape)).astype(np.float32)))
    return out


def _cycle(batches):
    while True:
        yield from batches


def _jax_trainer(model, input_type, tmp_path, train, val):
    return jtrainer.Trainer(
        model, _cycle(train), 1, _cycle(val), len(val), LR, 3, str(tmp_path / "jax"),
        input_type=input_type, mesh=make_mesh(1), augmenter=None,
        example_batch=train[0][0],
    )


def _port_trainer(model, input_type, tmp_path, train, val, name="port", **kw):
    return Trainer(
        model, _cycle(train), 1, _cycle(val), len(val), LR, 3, str(tmp_path / name),
        input_type=input_type, augmenter=None, device="cpu", **kw,
    )


def _grad_errors(got, want):
    """Per tensor: (error, largest |want|)."""
    return {k: (float((got[k] - want[k]).abs().max()), float(want[k].abs().max())) for k in want}


# ------------------------------------------------------------ "spec"


@pytest.fixture(scope="module")
def spec_run(tmp_path_factory):
    """Validation, one train step and validation again, in both trainers;
    JAX's gradient and Adam step in float64."""
    tmp = tmp_path_factory.mktemp("spec")
    train, val = _pairs(1, 1), _pairs(2, 2)
    jt = _jax_trainer(JUNet(1, 1, rate=0.0, base=8), "spec", tmp, train, val)
    params0 = jax.tree_util.tree_map(np.asarray, jt.state.params)
    stats0 = jax.tree_util.tree_map(np.asarray, jt.state.batch_stats)
    model = UNet(1, 1, rate=0.0, base=8)
    model.load_state_dict(convert.unet_state_dict_from_flax(params0, stats0))
    tt = _port_trainer(model, "spec", tmp, train, val)

    with jax.enable_x64(True):
        p64, s64 = (jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), t)
                    for t in (params0, stats0))
        clean, aug = (jnp.asarray(a, jnp.float64) for a in train[0])
        grads = jax.jit(jax.grad(lambda p: jt._loss_terms(
            p, s64, clean, aug, jax.random.PRNGKey(0), True)[0]))(p64)
        adam = optax.adam(LR, b1=0.9, b2=0.999)
        stepped = jax.jit(lambda g, p: optax.apply_updates(p, adam.update(g, adam.init(p), p)[0]))(
            grads, p64)
        to_np = lambda t: jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), t)  # noqa: E731
        grads, stepped = to_np(grads), to_np(stepped)

    out = {"val0": (jt.validation_epoch(), tt.validation_epoch())}
    out["train"] = (jt.train_epoch(1), tt.train_epoch(1))
    out["scheduler"] = (jt.scheduler.state_dict(), tt.scheduler.state_dict())
    after = convert.unet_state_dict_from_flax(
        jax.tree_util.tree_map(np.asarray, jt.state.params),
        jax.tree_util.tree_map(np.asarray, jt.state.batch_stats))
    on_jax_weights = UNet(1, 1, rate=0.0, base=8)
    on_jax_weights.load_state_dict(after)
    out["val1"] = (jt.validation_epoch(),
                   _port_trainer(on_jax_weights, "spec", tmp, train, val, "port1").validation_epoch())
    # the converter rounds the float64 leaves to float32: ~6e-8 relative
    out["grads"] = ({k: p.grad for k, p in tt.model.named_parameters()},
                    _params_only(convert.unet_state_dict_from_flax(grads, stats0)))
    out["adam64"] = _params_only(convert.unet_state_dict_from_flax(stepped, stats0))
    out["stats"] = (after, tt.model.state_dict())
    out["state0"] = convert.unet_state_dict_from_flax(params0, stats0)
    return out


def _params_only(state):
    return {k: v for k, v in state.items()
            if not k.endswith(("running_mean", "running_var", "num_batches_tracked"))}


def test_spec_train_step_loss_and_gradients_match_jax(spec_run):
    j_terms, t_terms = spec_run["train"]
    assert set(t_terms) == set(j_terms) == {"loss"}
    assert abs(t_terms["loss"] - j_terms["loss"]) <= 1e-5 * abs(j_terms["loss"])
    got, want = spec_run["grads"]
    assert set(got) == set(want)
    for k, (err, top) in _grad_errors(got, want).items():
        assert top > 0 and err <= 1e-4 * top, (k, err, top)


def test_spec_train_step_updates_match_jax(spec_run):
    """Running statistics against the JAX trainer's step, 1e-5; weights
    against optax.adam on JAX's float64 gradient where the gradient is well
    above its rounding (see the module docstring), with what that leaves out
    counted."""
    want, got = spec_run["stats"]
    before = spec_run["state0"]
    for k, w in want.items():
        if "running_" in k:
            assert rel_err(got[k].numpy(), w.numpy()) <= 1e-5, k
            assert float((got[k] - before[k]).abs().max()) > 1e-4, k  # the step moved them
        elif k.endswith("num_batches_tracked"):
            assert int(got[k]) == 1
    grads, j_grads = spec_run["grads"]
    errors = _grad_errors(grads, j_grads)
    left_out = total = 0
    for k, w in spec_run["adam64"].items():
        strong = j_grads[k].abs() > 10 * errors[k][0]
        left_out += int((~strong).sum())
        total += strong.numel()
        assert np.abs((got[k] - w)[strong].numpy()).max(initial=0.0) <= LR / 30, k
        assert abs(float((got[k] - before[k]).abs().max()) - LR) <= 1e-2 * LR, k
    assert left_out <= 0.01 * total, (left_out, total)


def test_validation_epoch_matches_jax(spec_run):
    for key in ("val0", "val1"):
        (j_loss, j_metrics), (t_loss, t_metrics) = spec_run[key]
        assert set(t_loss) == set(j_loss) == {"loss"} and set(t_metrics) == {"psnr"}
        assert abs(t_loss["loss"] - j_loss["loss"]) <= 1e-5 * abs(j_loss["loss"]), key
        assert abs(t_metrics["psnr"] - j_metrics["psnr"]) <= 1e-5 * abs(j_metrics["psnr"]), key
    j_sched, t_sched = spec_run["scheduler"]
    assert set(t_sched) == set(j_sched)
    assert t_sched["num_bad_epochs"] == j_sched["num_bad_epochs"]
    assert abs(t_sched["best"] - j_sched["best"]) <= 1e-5 * abs(j_sched["best"])


# ------------------------------------------------------------ "audio"


class JScale(fnn.Module):
    """pred = w * aug, one parameter."""

    @fnn.compact
    def __call__(self, x):
        return self.param("w", lambda key: jnp.asarray(0.8, jnp.float32)) * x


class Scale(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.w = torch.nn.Parameter(torch.tensor(0.8))

    def forward(self, x):
        return self.w * x


def test_audio_branch_terms_and_gradient_match_jax(tmp_path, monkeypatch):
    monkeypatch.setenv("MFPA_STFT_MATMUL", "0")
    train, val = _pairs(3, 1), _pairs(4, 1)
    jt = _jax_trainer(JScale(), "audio", tmp_path, train, val)
    tt = _port_trainer(Scale(), "audio", tmp_path, train, val)
    clean, aug = (jnp.asarray(a) for a in train[0])
    j_grad = jax.jit(jax.grad(
        lambda p: jt._loss_terms(p, {}, clean, aug, jax.random.PRNGKey(0), True)[0]
    ))(jt.state.params)["w"]
    j_terms, t_terms = jt.train_epoch(1), tt.train_epoch(1)
    assert set(t_terms) == set(j_terms) == {"loss", "l1_loss", "sc_loss", "mag_loss"}
    for k, v in j_terms.items():
        assert abs(t_terms[k] - v) <= 1e-5 * abs(v), k
    assert abs(float(tt.model.w.grad) - float(j_grad)) <= 1e-4 * abs(float(j_grad))
    # the CLI's factors: 0.5 each, the function's default being 0.1
    assert tt.factor_sc == tt.factor_mag == 0.5


# ------------------------------------------------------------ schedule


def test_scheduler_and_early_stopping_state_dicts_match_jax():
    losses = [1.0, 0.9, 0.9, 0.95, 0.89995, 0.7, 0.7, 0.7, 0.71, 0.69, 0.69, 0.69]
    pairs = [(ReduceLROnPlateau(factor=0.1, patience=2), jtrainer.ReduceLROnPlateau(factor=0.1, patience=2)),
             (EarlyStopping(patience=3), jtrainer.EarlyStopping(patience=3))]
    for loss in losses:
        for got, want in pairs:
            if isinstance(got, ReduceLROnPlateau):
                got.step(loss), want.step(loss)
            else:
                got(loss), want(loss)
            assert got.state_dict() == want.state_dict()
    assert pairs[0][0].scale < 1.0 and pairs[1][0].early_stop
    fresh = ReduceLROnPlateau()
    fresh.load_state_dict(pairs[0][0].state_dict())
    assert fresh.state_dict() == pairs[0][1].state_dict()


def test_an_epoch_runs_exactly_steps_steps(tmp_path):
    taken = []

    def counted():
        for batch in _cycle(_pairs(5, 2)):
            taken.append(1)
            yield batch

    tt = Trainer(Scale(), counted(), 3, _cycle(_pairs(6, 1)), 1, LR, 3, str(tmp_path),
                 input_type="audio", device="cpu")
    tt.train_epoch(1)
    assert len(taken) == 3 and tt.step == 3
    assert int(tt.optimizer.state[tt.model.w]["step"]) == 3


# ------------------------------------------------------------ checkpoints


def _augmented_trainer(ckpt, train_iter, nb_epochs, save=True):
    noise_bank, ir_bank = synthetic_banks(SR, num_noise=4, num_irs=2, noise_row_length=SR, device="cpu")
    fp = AugmentFP(noise_bank, SR, impulse_response_dir=ir_bank, device="cpu")
    torch.manual_seed(0)
    return Trainer(
        UNet(1, 1, rate=0.0, base=4), train_iter, 2, synthetic_clean_batches(BATCH, SR, SR, seed=8),
        2, LR, nb_epochs, str(ckpt), input_type="spec", augmenter=fp, save=save, device="cpu",
        scheduler=ReduceLROnPlateau(patience=0), early_stopping=EarlyStopping(patience=5),
    )


def test_save_resume_and_continuation_equal_an_uninterrupted_run(tmp_path):
    """Two epochs in one run against one epoch, a resume from ``last_epoch``
    and one more epoch: the same weights, optimizer state and history. The
    resumed run starts at the saved epoch (the last completed one) with the
    scheduler and early-stopping state of the save."""
    whole = _augmented_trainer(tmp_path / "whole", synthetic_clean_batches(BATCH, SR, SR, seed=7), 3)
    whole.training_loop()

    train_iter = synthetic_clean_batches(BATCH, SR, SR, seed=7)
    first = _augmented_trainer(tmp_path / "cut", train_iter, 2)
    first.training_loop()
    last = tmp_path / "cut" / "last_epoch"
    assert sorted(os.listdir(last)) == ["state.pt", "trainer_meta.json"]
    meta = json.loads((last / "trainer_meta.json").read_text())
    assert set(meta) == META_KEYS and meta["epoch"] == 1
    assert set(meta["scheduler"]) == set(jtrainer.ReduceLROnPlateau().state_dict())
    assert set(meta["early_stopping"]) == set(jtrainer.EarlyStopping().state_dict())
    assert (tmp_path / "cut" / "best_epoch" / "trainer_meta.json").exists()

    resumed = _augmented_trainer(tmp_path / "cut", train_iter, 2)
    assert resumed.epoch_start == 1 and resumed.step == 2
    assert resumed.scheduler.state_dict() == first.scheduler.state_dict()
    assert resumed.early_stopping.state_dict() == first.early_stopping.state_dict()
    assert resumed.min_valid_loss == first.min_valid_loss
    resumed.training_loop()

    for k, v in whole.model.state_dict().items():
        assert torch.equal(resumed.model.state_dict()[k], v), k
    for p, q in zip(whole.model.parameters(), resumed.model.parameters()):
        for name in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(whole.optimizer.state[p][name], resumed.optimizer.state[q][name])
    assert resumed.history[-1]["val"] == whole.history[-1]["val"]
    assert resumed.history[-1]["train"] == whole.history[-1]["train"]
    assert resumed.scheduler.state_dict() == whole.scheduler.state_dict()


def test_validation_replays_fixed_draws(tmp_path):
    trainer = _augmented_trainer(tmp_path, synthetic_clean_batches(BATCH, SR, SR, seed=7), 3, save=False)
    v1, m1 = trainer.validation_epoch()
    v2, m2 = trainer.validation_epoch()
    assert v1 == v2 and m1 == m2
    assert trainer.scheduler.best <= v1["loss"]


@pytest.mark.filterwarnings("ignore:Full backward hook is firing")
def test_strict_float32_step_runs_its_backward_with_tf32_off(tmp_path):
    """The backward convolutions run inside the step's cuDNN context: cuDNN
    enabled, TF32 off (a ``loss.backward()`` outside it would take cuDNN's
    default, TF32 allowed)."""
    seen = []

    def record(*_):
        seen.append((torch.backends.cudnn.enabled, torch.backends.cudnn.allow_tf32))

    trainer = _augmented_trainer(tmp_path, synthetic_clean_batches(BATCH, SR, SR, seed=7), 3, save=False)
    convs = [m for m in trainer.model.modules() if isinstance(m, torch.nn.Conv2d)]
    for m in convs:
        m.register_full_backward_hook(record)
    assert torch.backends.cudnn.allow_tf32  # the default outside
    trainer.train_step(*trainer._get_batch(trainer.train_iter))
    assert len(seen) == len(convs)
    assert set(seen) == {(torch.backends.cudnn.enabled, False)}
    assert torch.backends.cudnn.enabled and torch.backends.cudnn.allow_tf32


# ------------------------------------------------------------ conversion


@pytest.mark.parametrize("bilinear", [False, True], ids=["convT", "bilinear"])
def test_unet_state_dict_to_flax_round_trip(bilinear):
    """Port weights -> Flax leaves -> port weights, and back again: leaves
    equal; the JAX UNet on the Flax leaves equals the port's forward within
    1e-5 of the largest output."""
    torch.manual_seed(4)
    model = UNet(1, 1, base=8, bilinear=bilinear)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.uniform_(-0.1, 0.1)
                m.running_var.uniform_(0.5, 1.5)
                m.weight.uniform_(0.8, 1.2)
                m.bias.uniform_(-0.1, 0.1)
    model.eval()
    state = model.state_dict()
    params, stats = convert.unet_state_dict_to_flax(state)
    back = convert.unet_state_dict_from_flax(params, stats)
    assert set(back) == set(state)
    for k, v in state.items():
        assert torch.equal(back[k], v) if "num_batches" not in k else int(back[k]) == 0, k
    again = convert.unet_state_dict_to_flax(back)
    flat = jax.tree_util.tree_flatten_with_path
    want = {jax.tree_util.keystr(k): v for k, v in flat({"p": params, "s": stats})[0]}
    got = {jax.tree_util.keystr(k): v for k, v in flat({"p": again[0], "s": again[1]})[0]}
    assert set(got) == set(want) and len(want) == len(state) - sum("num_batches" in k for k in state)
    for k, v in want.items():
        assert got[k].dtype == np.float32
        np.testing.assert_array_equal(got[k], v, err_msg=k)

    jm = JUNet(1, 1, base=8, bilinear=bilinear)
    x = np.random.default_rng(5).uniform(0.0, 1.0, (2, 33, 47)).astype(np.float32)
    j_out = np.asarray(jax.jit(jm.apply)({"params": params, "batch_stats": stats}, jnp.asarray(x)))
    with torch.no_grad():
        t_out = model(torch.from_numpy(x)).numpy()
    assert rel_err(t_out, j_out) <= 1e-5
    with pytest.raises(ValueError, match="no leaf"):
        convert.unet_state_dict_to_flax(dict(state, extra=torch.zeros(1)))


# ------------------------------------------------------------ CLI, devices


def test_train_cli_runs_two_epochs_and_writes_jax_meta(tmp_path, monkeypatch):
    monkeypatch.setattr(ttrain, "CHECKPOINT_ROOT", str(tmp_path))
    trainer = ttrain.main(["--device", "cpu", "--epochs", "3", "--batch-size", "2",
                           "--train-steps", "1", "--val-steps", "1", "--base", "4", "--save"])
    assert [h["epoch"] for h in trainer.history] == [1, 2]
    assert trainer.model.base == 4 and trainer.model.rate == 0.05 and trainer.augmenter is not None
    meta_path = tmp_path / "unet_lr_0.001_BS_2" / "last_epoch" / "trainer_meta.json"
    meta = json.loads(meta_path.read_text())
    assert set(meta) == META_KEYS and meta["epoch"] == 2
    assert all(np.isfinite(h["val"]["loss"]) for h in trainer.history)


@pytest.mark.parametrize("flag,item", [(["--model", "demucs"], "item 2"), (["--multihost"], "item 4")])
def test_cli_options_not_ported_raise(flag, item):
    with pytest.raises(NotImplementedError, match=item):
        ttrain.main(["--device", "cpu"] + flag)


def test_trainer_rejects_demucs_and_needs_cuda_by_default(tmp_path):
    class Demucs(torch.nn.Module):
        pass

    batches = _cycle(_pairs(9, 1))
    with pytest.raises(NotImplementedError, match="item 2"):
        Trainer(Demucs(), batches, 1, batches, 1, LR, 2, str(tmp_path), device="cpu")
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Trainer(Scale(), batches, 1, batches, 1, LR, 2, str(tmp_path))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ttrain.main(["--epochs", "2"])
