"""Cross-cutting utilities: profiling, configuration."""

from musicfpaugment_torch.utils.config import TrainConfig, parse_into
from musicfpaugment_torch.utils.profiling import StageTimer, annotate, trace

__all__ = ["TrainConfig", "parse_into", "StageTimer", "annotate", "trace"]
