"""Tensor ops and kernels: the RNG streams and the fused render kernel."""
