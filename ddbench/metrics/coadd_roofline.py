"""Completed coadds times one coadd's least time over all kernel time (torch.profiler)."""
from ddbench.readers import coadd_roofline as read  # noqa: F401
