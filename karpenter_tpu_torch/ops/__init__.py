"""Solver ops of the port: tensorize, the class-granular pack and its
CUDA kernel wrappers."""
