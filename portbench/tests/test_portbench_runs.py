"""Whole runs of every cell on the CPU at small sizes: the result line, the
program against the plain reference, and ``correct`` coming out false
with the timed path broken underneath (an answer altered where it is
produced, half of a batch left out, a step that leaves its state
unchanged) and with the reference at a lower precision in the program's
place (the control). The card's own readings of the control are
``calibrate.py``'s; its tests here carry the ``cuda`` marker."""

from __future__ import annotations

import pytest
import torch

from portbench import harness as H
from portbench.tests import tiny

KEYS = {"correct", "attempted", "failed", "metrics", "device", "checks"}
CELLS = [w["name"] for w in H.load_manifest()["workloads"]]


@pytest.fixture(autouse=True)
def few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(autouse=True, scope="module")
def input_cache(tmp_path_factory):
    """The small runs' kept inputs in a directory of their own, shared by
    the module's tests."""
    keep = H.CACHE_DIR
    H.CACHE_DIR = str(tmp_path_factory.mktemp("portbench_cache"))
    yield
    H.CACHE_DIR = keep


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: TF32 exists only on the card")


@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_and_agrees_with_the_reference(cell):
    rc, line, err = tiny.run_cell(cell)
    assert rc == 0, err[-3000:]
    assert set(line) == KEYS and list(line)[-1] == "checks"
    assert line["correct"] is True, err[-3000:]
    assert line["failed"] == 0 and line["attempted"] > 0
    assert "setup_s" in line["metrics"] and len(line["metrics"]) >= 2
    assert all(set(m) == {"value", "unit"} for m in line["metrics"].values())
    assert set(line["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    assert all(set(c) == {"value", "limit"} for c in line["checks"].values())
    assert "portbench: check" in err.strip().splitlines()[-1]


def test_traced_run_reports_per_layer_metrics():
    rc, line, err = tiny.run_cell("unet64-train", trace=1)
    assert rc == 0 and line["correct"] is True, err[-3000:]
    assert set(line["metrics"]) <= {m["name"] for m in H.load_manifest()["per_layer"]}
    assert "mfu.train" in line["metrics"] and "augment_host_ms.train" in line["metrics"]
    assert {"busy_s", "window_s"} <= set(line["device"])
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}


def _altered_verdicts(monkeypatch):
    from musicfpaugment_torch.afp.audfprint.matcher_device import DeviceMatcher

    orig = DeviceMatcher._verdicts

    def altered(self, *args, **kw):
        return [(status, name, count + 1) for status, name, count in orig(self, *args, **kw)]

    monkeypatch.setattr(DeviceMatcher, "_verdicts", altered)


def _half_batch_left_out(monkeypatch):
    """The matcher hashes the first half of each batch and nothing of the
    rest (its rows silent), so their verdicts come back empty."""
    from musicfpaugment_torch.afp.audfprint.matcher_device import DeviceMatcher

    orig = DeviceMatcher.match_waveforms

    def half(self, waveforms, **kw):
        kept = waveforms.clone()
        kept[waveforms.shape[0] // 2 :] = 0
        return orig(self, kept, **kw)

    monkeypatch.setattr(DeviceMatcher, "match_waveforms", half)


@pytest.mark.parametrize("cell", [c for c in CELLS if "identify" in c])
@pytest.mark.parametrize("fault", [_altered_verdicts, _half_batch_left_out])
def test_identify_fault_is_not_correct(cell, fault, monkeypatch):
    fault(monkeypatch)
    rc, line, err = tiny.run_cell(cell)
    assert rc == 0, err[-3000:]
    assert line["correct"] is False


def _state_unchanged(monkeypatch):
    from musicfpaugment_torch.train.trainer import Trainer

    orig = Trainer.__init__

    def init(self, *args, **kw):
        orig(self, *args, **kw)
        self.optimizer.step = lambda closure=None: None

    monkeypatch.setattr(Trainer, "__init__", init)


def _loss_over_half_batch(monkeypatch):
    from musicfpaugment_torch.train import trainer as T

    orig = T.l1_loss
    monkeypatch.setattr(T, "l1_loss", lambda x, y: orig(x[: x.shape[0] // 2], y[: y.shape[0] // 2]))


@pytest.mark.parametrize("fault", [_state_unchanged, _loss_over_half_batch])
def test_train_fault_is_not_correct(fault, monkeypatch):
    fault(monkeypatch)
    rc, line, err = tiny.run_cell("unet64-train")
    assert rc == 0, err[-3000:]
    assert line["correct"] is False


@pytest.mark.parametrize("cell", [c for c in CELLS if "identify-plain" in c])
def test_bf16_spectrogram_control_fails_a_limit(cell):
    """The control of a cell without a model runs anywhere; TF32 needs the
    card (below)."""
    readings = _control_readings(cell, "bf16_spectrogram")
    limits = H.read_json(f"portbench/limits/{cell}.json")["limits"]
    assert any(v > limits[k] for k, v in readings.items()), readings


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [c for c in CELLS if "identify" in c and "plain" not in c])
def test_tf32_control_fails_a_limit(cell, cuda):
    """At the configuration's own widths, which the limits were set at: at
    the CPU tests' (Demucs hidden 16, depth 3) TF32 moved the output by
    2.7e-5 of its peak only, under ``den_rel``'s 5e-5, and failed nothing."""
    readings = _control_readings(cell, "tf32", device="cuda", published_widths=True)
    limits = H.read_json(f"portbench/limits/{cell}.json")["limits"]
    assert any(v > limits[k] for k, v in readings.items()), readings


@pytest.mark.cuda
def test_train_tf32_control_fails_a_limit(cuda):
    import os
    import time

    from portbench.judge import train as J

    run = H.Run(H.load_manifest(), "unet64-train", 77, 0.0, False, "cuda", time.perf_counter(),
                tiny.overrides("unet64-train"))
    D = H.load_file_module(os.path.join(H.BENCH_DIR, "drivers", "train.py"), "pb_tr_t")
    st = D.setup(run)
    st.pop("trainer")
    st.pop("checkpoint").cleanup()
    args = (run.config, run.traffic, st["seeds"], st["banks"], st["batches"][:3], "cuda")
    readings = J.compare(J.reference_steps(*args, "tf32"), J.reference_steps(*args, "strict"))
    limits = H.read_json("portbench/limits/unet64-train.json")["limits"]
    assert any(v > limits[k] for k, v in readings.items())


def _control_readings(cell: str, precision: str, device: str = "cpu",
                      published_widths: bool = False) -> dict:
    """The control's numbers over every query of the recorded batches, at
    the small sizes (with the configuration's own model if
    ``published_widths``)."""
    import os
    import time

    from portbench.judge import identify as J

    ov = tiny.overrides(cell)
    if published_widths:
        del ov["config"]["model_args"]
    ov["traffic"]["sample_queries"] = 2 * ov["traffic"]["batch"]
    run = H.Run(H.load_manifest(), cell, 77, 0.0, False, device, time.perf_counter(), ov)
    D = H.load_file_module(os.path.join(H.BENCH_DIR, "drivers", "identify.py"), "pb_id_t")
    st = D.setup(run)
    step = D.batch_step(run, st)
    for i in range(max(st["rec_batches"]) + 1):
        step(i)
    waves, prog, table, _ = D.sample(run, st)
    hook = None
    if "denoised" in prog:
        _, hook = J.reference_denoiser(run.config, device,
                                       J.I.denoiser_weights(run.config, st["seeds"]["weights"], device))
    low = {arm: J.reference_outputs(run.config, waves, arm, hook, table, precision)
           for arm in prog}
    return D.reference_numbers(run, waves, low, table, "strict")
