"""What the per-layer readers compute; each ``metrics/<name>.py`` names
one of these for its metric. A reader returns None where the run gave it
nothing to read."""

from __future__ import annotations

from portbench import harness as H
from portbench import inputs as I

DROPOUT_OPS_PER_ELEMENT = 80


def device_idle_pct(run):
    """The share of the profiled slice in which no operation ran on the
    device: 1 - (union of the device's intervals / the slice's length on
    the host's clock)."""
    trace = run.layer.get("trace")
    if not trace or trace["window_s"] <= 0 or not trace["device"]:
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])


def mfu(run):
    """The model's share of the card's float32 peak over the window: the
    FLOPs of every batch or step of the window (forward, or 3 x forward for
    a training step; convolutions counted as direct convolutions and the
    LSTM's gate products, from the shapes each layer sees) over the
    window's seconds x 67 TFLOP/s. A cell without a model reads nothing."""
    flops = run.layer.get("model_flops", 0)
    if not flops:
        return None
    return 100.0 * flops / run.layer["window_s"] / H.FP32_FLOP_PER_S


def prune_roofline(run):
    """Both prune kernels' share of their roofline in the profiled slice:
    the least time the bytes and operations of every launch need at the
    card's peaks (the launch's shape, the kept peaks of the recorded
    batches), over the kernels' device time in the trace. Nothing is read
    if the trace's launches are not the program's count of them."""
    trace = run.layer.get("trace")
    launches = run.layer.get("prune_launches")
    if not trace or not launches:
        return None
    fwd_s, fwd_n = H.device_seconds(trace, lambda n: "fwd_kernel" in n)
    bwd_s, bwd_n = H.device_seconds(trace, lambda n: "bwd_kernel" in n)
    if fwd_n == 0 or fwd_n != launches["forward_prune"] or bwd_n != launches["backward_prune"]:
        return None
    B, F, C = run.layer["prune_shape"]
    kept = int(run.layer["prune_kept_peaks"])
    (fb, fo), (bb, bo) = I.prune_work(B, F, C, kept, kept)
    least = (fwd_n * I.least_seconds(fb, fo, H.FP32_FLOP_PER_S, H.HBM_BYTES_PER_S)
             + bwd_n * I.least_seconds(bb, bo, H.FP32_FLOP_PER_S, H.HBM_BYTES_PER_S))
    return 100.0 * least / (fwd_s + bwd_s)


def dropout_roofline(run):
    """The dropout kernel's share of its roofline in the profiled slice:
    the least time of every launch at the card's peaks (float32 read and
    written once an element; ~80 32-bit operations an element for the
    threefry rounds, the key injections, the uniform and the test, counted
    at the float32 rate), over the kernel's device time in the trace.
    Nothing is read if the trace's launches are not the program's count."""
    trace = run.layer.get("trace")
    elements = run.layer.get("dropout_elements")
    launches = run.layer.get("dropout_launches")
    if not trace or not elements or not launches:
        return None
    secs, n = H.device_seconds(trace, lambda name: "dropout_kernel" in name)
    if n == 0 or n != launches:
        return None
    least = sum(I.least_seconds(8 * e, DROPOUT_OPS_PER_ELEMENT * e, H.FP32_FLOP_PER_S,
                                H.HBM_BYTES_PER_S) for e in elements)
    return 100.0 * least / secs


def augment_host_ms(run):
    """Host milliseconds a training step spends in the trainer's calls
    into its augmenter (the draws and the launch of the chain), from the
    benchmark's own span around those calls over steady steps."""
    spans = run.layer.get("augment_host_s")
    steps = run.layer.get("augment_steps")
    if not spans or not steps:
        return None
    return 1e3 * spans / steps
