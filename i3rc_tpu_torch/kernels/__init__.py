"""Hand-written CUDA kernels, their plain PyTorch twins, and their build."""
