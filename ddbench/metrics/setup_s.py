"""Seconds from process start to the window's open (host clock)."""
from ddbench.readers import setup_s as read  # noqa: F401
