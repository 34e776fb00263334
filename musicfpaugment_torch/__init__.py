"""musicfpaugment_torch — PyTorch/CUDA port of musicfpaugment_tpu for one
NVIDIA H100.

The JAX package stays the reference; every module here mirrors the module
path of its JAX counterpart and is held against it in tests/test_torch_*.py.
The TPU's Pallas kernels become hand-written CUDA C++ kernels under
``csrc/`` (built with nvcc at first use, see ``_build.py``); their plain
PyTorch versions serve CPU tensors only.

Ported so far: audfprint identification (``afp.audfprint``), the augmenter
and the query generator (``augment``, ``testing.generate_queries``), the
UNet spectrogram denoiser with its Flax-weights converter (``models``,
``convert``), and the audfprint evaluation harness with the peak metrics
(``testing.audfprint_exps``, ``testing.metrics``). ``ROADMAP.md`` lists what
is left.
"""

from musicfpaugment_torch.device import resolve_device

__version__ = "0.1.0"
__all__ = ["resolve_device"]
