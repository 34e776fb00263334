"""Cross-cutting utilities: profiling."""

from musicfpaugment_torch.utils.profiling import StageTimer, annotate, trace

__all__ = ["StageTimer", "annotate", "trace"]
