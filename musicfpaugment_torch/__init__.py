"""musicfpaugment_torch — PyTorch/CUDA port of musicfpaugment_tpu for one
NVIDIA H100.

The JAX package stays the reference; every module here mirrors the module
path of its JAX counterpart and is held against it in tests/test_torch_*.py.
The TPU's Pallas kernels become hand-written CUDA C++ kernels under
``csrc/`` (built with nvcc at first use, see ``_build.py``); their plain
PyTorch versions serve CPU tensors only.

Every module of the JAX package has its counterpart here: audfprint and
Dejavu (``afp``), the augmenter (``augment``), the UNet and Demucs
denoisers with their Flax-weights converters (``models``, ``convert``),
their training with monitoring (``train``), the evaluation harness over the
FMA selection (``testing``), the native audio decoders (``data``), the
parallel layer (``parallel``) and the demo app (``apps``). ``ROADMAP.md``
lists what is left out on purpose (TPU layouts).
"""

from musicfpaugment_torch.device import resolve_device

__version__ = "0.1.0"
__all__ = ["resolve_device"]
