"""Mean task function: the recorder's exec_end less exec_start."""
from ddbench.readers import fn_ms_mean as read  # noqa: F401
