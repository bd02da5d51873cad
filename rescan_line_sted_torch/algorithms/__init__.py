"""Metrics (``fwhm_1d`` so far)."""
