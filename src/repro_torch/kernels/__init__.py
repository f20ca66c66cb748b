"""Hand-written CUDA kernels of the routing path and their plain versions."""
