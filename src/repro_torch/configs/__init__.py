"""Workload configurations the port runs (counterpart of ``repro.configs``)."""
