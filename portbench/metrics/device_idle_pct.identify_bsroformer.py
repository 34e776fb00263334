"""The device's idle share in the profiled slice (``readers.device_idle_pct``)."""

from portbench.readers import device_idle_pct as read  # noqa: F401
