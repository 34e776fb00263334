"""Does splitting a batch help the port's UNet on the card?

    python3 examples/torch_unet_chunks.py        (from the repo's root, one NVIDIA GPU)

A strict-float32 forward of 128 (257, 251) spectrograms through the
``base=64`` UNet of ``musicfpaugment_torch`` (weights from
``chip_smoke.seeded_unet``), whole and in chunks of 64, 32, 16 and 8, with
``torch.backends.cudnn.benchmark`` off and on: ms per 128 (CUDA events, 2
calls after a warm-up) and the peak of allocated memory above the start.
Prints the card's name and power limit, then one JSON line per setting.
"""

import json
import subprocess
import sys

import torch

sys.path.insert(0, ".")
import chip_smoke  # noqa: E402
from musicfpaugment_torch.convert import unet_denoiser  # noqa: E402


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("needs an NVIDIA GPU")
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    print(smi.stdout.strip(), flush=True)
    hook = unet_denoiser(chip_smoke.seeded_unet(chip_smoke.UNET_SEED).to(dev))
    # magnitudes shaped like a normalised spectrogram: most bins near 0
    x = torch.rand((128, 257, 251), generator=torch.Generator().manual_seed(0)).to(dev) ** 4
    whole = hook(x)
    for benchmark in (False, True):
        torch.backends.cudnn.benchmark = benchmark
        for chunk in (128, 64, 32, 16, 8):
            def forward():
                return torch.cat([hook(x[i : i + chunk]) for i in range(0, 128, chunk)])

            start = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            ms = chip_smoke.gpu_ms(forward, 2)
            print(json.dumps({
                "cudnn_benchmark": benchmark, "chunk": chunk, "ms_per_128": ms,
                "peak_bytes_above_start": torch.cuda.max_memory_allocated() - start,
                "max_abs_vs_whole": float((forward() - whole).abs().max()),
                "output_max_abs": float(whole.abs().max()),
            }), flush=True)


if __name__ == "__main__":
    main()
