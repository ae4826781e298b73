"""Store reads over the distinct files the window's requests named (Task ledger)."""
from ddbench.readers import store_reads_per_file as read  # noqa: F401
