"""Share of the profiled span with no kernel or copy on the card (torch.profiler)."""
from ddbench.readers import device_idle as read  # noqa: F401
