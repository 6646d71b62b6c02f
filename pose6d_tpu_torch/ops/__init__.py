"""Device ops: crop+resize, eval preprocessing, BN folding, CUDA kernels."""
