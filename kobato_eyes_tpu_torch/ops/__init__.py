"""Device kernels: hand-written CUDA for Hopper, each beside its plain torch
version (which the CPU tests use and the chip smoke compares against)."""
