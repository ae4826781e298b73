"""Requests completed in the window per second (host clock)."""
from ddbench.readers import tasks_per_s as read  # noqa: F401
