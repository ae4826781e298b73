"""Applications that run on the port (the paper's SDSS stacking: astro.py)."""
