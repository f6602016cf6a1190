"""Hand-written CUDA kernels (with plain PyTorch versions) and the plain
torch search and warp ops of the port."""
