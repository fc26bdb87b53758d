"""Kernels (CUDA, built at first use) and the tensor ops around them."""
