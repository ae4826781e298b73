"""Mean input staging: the recorder's exec_start less Task.start_time."""
from ddbench.readers import stage_ms_mean as read  # noqa: F401
