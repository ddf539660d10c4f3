"""Device ops: the four CUDA kernels with their plain versions, and the
passes built on them."""
