"""Seconds from the open until the pool first reached its peak (host clock samples)."""
from ddbench.readers import pool_ramp_s as read  # noqa: F401
