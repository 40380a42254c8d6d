"""Hand-written CUDA kernels for Hopper, their plain PyTorch twins, and
the adapters the game calls (``ops``)."""
