"""Device compute: encode, channel constants, fused kernels, metrics."""
