"""Both prune kernels' share of their roofline (``readers.prune_roofline``)."""

from portbench.readers import prune_roofline as read  # noqa: F401
