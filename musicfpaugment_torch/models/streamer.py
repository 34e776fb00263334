"""Streaming Demucs inference, frame by frame with carried state (port of
musicfpaugment_tpu/models/streamer.py).

Feed any amount of audio, get back as much denoised audio as is causally
available. State carried between frames: per non-final encoder layer its
output over the current window (so only the new hop is recomputed), per
decoder layer the transposed convolution's tail, the LSTM's ``(h, c)``, the
sinc resampler's edge buffers and the online normalisation variance (a mean
of squares). The frame's math runs on the model's device through its own
layers, with the pending audio and every buffer kept there: a frame makes
no round trip to the host, and :meth:`DemucsStreamer.feed` copies out only
what it returns.

``python -m musicfpaugment_torch.models.streamer [--device cpu]`` is the
reference's self-benchmark: model size, batch/streaming delta, initial lag,
time per frame and real-time factor.
"""

from __future__ import annotations

import time
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from musicfpaugment_torch.core.resample import downsample2, upsample2
from musicfpaugment_torch.device import cudnn_tf32
from musicfpaugment_torch.models.demucs import Demucs
from musicfpaugment_torch.models.flax_init import flax_init


class DemucsStreamer:
    """Real-time streaming of a causal :class:`Demucs`, in float32 on the
    model's device. ``dry`` mixes the input back in, ``num_frames`` trades
    latency for throughput."""

    def __init__(
        self,
        demucs: Demucs,
        dry: float = 0,
        num_frames: int = 1,
        resample_lookahead: int = 64,
        resample_buffer: int = 256,
    ) -> None:
        if not demucs.causal:
            raise ValueError("streaming needs the causal (LSTM) Demucs")
        self.demucs = demucs
        self.device = next(demucs.parameters()).device
        self.lstm_state: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
        self.conv_state: Optional[List[torch.Tensor]] = None
        self.dry = dry
        self.resample_lookahead = resample_lookahead
        resample_buffer = min(demucs.total_stride, resample_buffer)
        self.resample_buffer = resample_buffer
        self.frame_length = demucs.valid_length(1) + demucs.total_stride * (num_frames - 1)
        self.total_length = self.frame_length + resample_lookahead
        self.stride = demucs.total_stride * num_frames
        zeros = lambda n: torch.zeros((demucs.chin, n), device=self.device)  # noqa: E731
        self.resample_in = zeros(resample_buffer)
        self.resample_out = zeros(resample_buffer)
        self.frames = 0
        self.total_time = 0.0
        self.variance = torch.zeros((), device=self.device)
        self.pending = zeros(0)
        demucs.lstm.lstm.flatten_parameters()

    def reset_time_per_frame(self) -> None:
        self.total_time = 0.0
        self.frames = 0

    @property
    def time_per_frame(self) -> float:
        return self.total_time / max(self.frames, 1)

    def flush(self) -> torch.Tensor:
        """Zero-pad out the remaining audio and reset the carried state."""
        self.lstm_state = None
        self.conv_state = None
        pending_length = self.pending.shape[1]
        out = self.feed(torch.zeros((self.demucs.chin, self.total_length)))
        return out[:, :pending_length]

    def feed(self, wav) -> torch.Tensor:
        """(chin, T) audio, numpy or a tensor on any device -> (chin, k *
        stride) float32 on the host: every frame that the pending audio
        completes."""
        begin = time.perf_counter()
        demucs = self.demucs
        wav = torch.as_tensor(wav, dtype=torch.float32).to(self.device)
        if wav.ndim != 2:
            raise ValueError("input wav should be two dimensional.")
        chin, _ = wav.shape
        if chin != demucs.chin:
            raise ValueError(f"Expected {demucs.chin} channels, got {chin}")
        self.pending = torch.cat([self.pending, wav], dim=1)
        outs = []
        with torch.inference_mode(), cudnn_tf32(False):
            while self.pending.shape[1] >= self.total_length:
                outs.append(self._feed_frame(self.pending[:, : self.total_length]))
                self.pending = self.pending[:, self.stride :]
        out = torch.cat(outs, dim=1).cpu() if outs else torch.zeros((chin, 0))
        self.total_time += time.perf_counter() - begin
        return out

    def _feed_frame(self, frame: torch.Tensor) -> torch.Tensor:
        demucs = self.demucs
        resample, resample_buffer, stride = demucs.resample, self.resample_buffer, self.stride
        self.frames += 1
        dry_signal = frame[:, :stride]
        if demucs.normalize:
            variance = (frame.mean(dim=0) ** 2).mean()
            self.variance = variance / self.frames + (1 - 1 / self.frames) * self.variance
            frame = frame / (demucs.floor + self.variance.sqrt())
        padded_frame = torch.cat([self.resample_in, frame], dim=-1)
        self.resample_in = frame[:, stride - resample_buffer : stride]
        frame = padded_frame
        if resample == 4:
            frame = upsample2(upsample2(frame))
        elif resample == 2:
            frame = upsample2(frame)
        frame = frame[:, resample * resample_buffer :][:, : resample * self.frame_length]

        out, extra = self._separate_frame(frame)
        padded_out = torch.cat([self.resample_out, out, extra], dim=-1)
        self.resample_out = out[:, -resample_buffer:]
        if resample == 4:
            out = downsample2(downsample2(padded_out))
        elif resample == 2:
            out = downsample2(padded_out)
        else:
            out = padded_out
        out = out[:, resample_buffer // resample :][:, :stride]
        if demucs.normalize:
            out = out * self.variance.sqrt()
        return self.dry * dry_signal + (1 - self.dry) * out

    def _separate_frame(self, frame: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(chin, T) upsampled frame -> (chout, T') output and the
        (chout, stride) tail that overlaps the next frame. ``conv_state``
        holds, per non-final encoder layer, the layer's output over the
        current window and, per decoder layer, the transposed convolution's
        tail without its bias."""
        demucs = self.demucs
        k, s = demucs.kernel_size, demucs.stride
        first = self.conv_state is None
        state_in = [] if first else list(self.conv_state)
        next_state: List[torch.Tensor] = []
        stride = self.stride * demucs.resample
        x = frame[None]
        skips = []
        for idx, encode in enumerate(demucs.encoder):
            stride //= s
            length = x.shape[2]
            if idx == demucs.depth - 1:
                x = encode(x)
            else:
                prev = None
                if not first:
                    prev = state_in.pop(0)[..., stride:]
                    missing = (length - k) // s + 1 - prev.shape[-1]
                    x = x[..., length - k - s * (missing - 1) :]
                x = encode(x)
                if prev is not None:
                    x = torch.cat([prev, x], dim=-1)
                next_state.append(x)
            skips.append(x)

        x, self.lstm_state = demucs.lstm(x.transpose(1, 2), self.lstm_state)
        x = x.transpose(1, 2)

        extra = None
        for idx, decode in enumerate(demucs.decoder):
            conv1x1, act, convt = decode[0], decode[1], decode[2]
            skip = skips.pop(-1)
            x = act(conv1x1(x + skip[..., : x.shape[-1]]))
            if extra is not None:
                skip_tail = skip[..., x.shape[-1] :]
                extra = convt(act(conv1x1(extra + skip_tail[..., : extra.shape[-1]])))
            x = convt(x)
            next_state.append(x[..., -s:] - convt.bias.view(-1, 1))
            if extra is None:
                extra = x[..., -s:]
            else:
                extra = torch.cat([extra[..., :s] + next_state[-1], extra[..., s:]], dim=-1)
            x = x[..., :-s]
            if not first:
                x = torch.cat([x[..., :s] + state_in.pop(0), x[..., s:]], dim=-1)
            if idx != demucs.depth - 1:
                x = F.relu(x)
                extra = F.relu(extra)
        self.conv_state = next_state
        return x[0], extra[0]


def _benchmark(argv=None) -> None:
    """The reference's streaming self-benchmark."""
    import argparse

    from musicfpaugment_torch.device import resolve_device

    parser = argparse.ArgumentParser(
        "musicfpaugment_torch.models.streamer",
        description="Benchmark the streaming Demucs implementation and check "
        "the delta with the offline implementation.",
    )
    parser.add_argument("--depth", default=5, type=int)
    parser.add_argument("--resample", default=4, type=int)
    parser.add_argument("--hidden", default=48, type=int)
    parser.add_argument("--sample_rate", default=16000, type=float)
    parser.add_argument("-f", "--num_frames", type=int, default=1)
    parser.add_argument("--seconds", type=float, default=10.0)
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    sr_ms = args.sample_rate / 1000
    demucs = Demucs(hidden=args.hidden, depth=args.depth, resample=args.resample).to(device)
    demucs = flax_init(demucs).eval()  # the JAX streamer's demucs.init(PRNGKey(0), x)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((1, int(args.sample_rate * args.seconds)), dtype=np.float32))
    with torch.inference_mode():
        out = demucs(x.to(device)).cpu()
    streamer = DemucsStreamer(demucs, num_frames=args.num_frames)
    out_lst = []
    frame_size = streamer.total_length
    pending = x
    while pending.shape[1] > 0:
        out_lst.append(streamer.feed(pending[:, :frame_size]))
        pending = pending[:, frame_size:]
        frame_size = demucs.total_stride
    out_lst.append(streamer.flush())
    out_rt = torch.cat(out_lst, dim=1)
    model_size = sum(p.numel() for p in demucs.parameters()) * 4 / 2**20
    initial_lag = streamer.total_length / sr_ms
    tpf = 1000 * streamer.time_per_frame
    delta = float(torch.linalg.norm(out - out_rt[:, : out.shape[1]]) / torch.linalg.norm(out))
    print(f"model size: {model_size:.1f}MB, ", end="")
    print(f"delta batch/streaming: {delta:.2%}")
    print(f"initial lag: {initial_lag:.1f}ms, ", end="")
    print(f"stride: {streamer.stride * args.num_frames / sr_ms:.1f}ms")
    print(f"time per frame: {tpf:.1f}ms, ", end="")
    print(f"RTF: {tpf / (streamer.stride / sr_ms):.2f}")
    print(f"Total lag with computation: {initial_lag + tpf:.1f}ms")


if __name__ == "__main__":
    _benchmark()
