"""Physics: PSF profiles, illumination models, dose, shot noise."""
