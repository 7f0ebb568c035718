"""Hand-written CUDA kernels for Hopper (`csrc/`), each with its plain
PyTorch version beside it and a launch counter on its wrapper."""
