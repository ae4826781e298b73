"""95th percentile of completion less due time over the window's requests (host clock)."""
from ddbench.readers import latency_p95_ms as read  # noqa: F401
