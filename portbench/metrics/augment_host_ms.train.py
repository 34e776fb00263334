"""Host ms a step in the trainer's augmenter calls (``readers.augment_host_ms``)."""

from portbench.readers import augment_host_ms as read  # noqa: F401
