"""Packed ternary linears, the SSR gather and the CUDA kernels."""
