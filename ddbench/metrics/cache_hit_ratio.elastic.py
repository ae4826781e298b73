"""Inputs served by a local or peer cache over inputs read (Task ledger)."""
from ddbench.readers import cache_hit_ratio as read  # noqa: F401
