"""The model's share of the float32 peak over the window (``readers.mfu``)."""

from portbench.readers import mfu as read  # noqa: F401
