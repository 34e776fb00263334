"""The dropout kernel's share of its roofline (``readers.dropout_roofline``)."""

from portbench.readers import dropout_roofline as read  # noqa: F401
