"""The benchmark of repro_torch: SDSS stacking over data diffusion."""
