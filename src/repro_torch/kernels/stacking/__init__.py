"""SDSS image stacking (calibrate, bilinear sub-pixel shift, coadd)."""
