"""Executor-seconds over the window and its drain per 1,000 requests (host clock)."""
from ddbench.readers import executor_s_per_ktask as read  # noqa: F401
