"""Math, physics, binning and the fused kernel wrappers."""
