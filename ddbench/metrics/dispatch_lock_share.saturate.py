"""Share of the window the dispatch lock was held (DispatchStats.lock_hold_s)."""
from ddbench.readers import dispatch_lock_share as read  # noqa: F401
