"""Solver ops of the port: tensorize, the class-granular pack, the LP
guide with its PDHG solver, the certified cost bounds, and the CUDA kernel
wrappers."""
