"""Hand-written CUDA kernels (built from csrc/ at first use) and their plain versions."""
