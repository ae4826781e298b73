"""95th percentile of Task.dispatch_time less Task.submit_time."""
from ddbench.readers import queue_wait_p95_ms as read  # noqa: F401
