"""Device ops of the port: plain PyTorch, plus the hand-written CUDA kernels
behind ``ops.kernels``."""
