"""Hand-written CUDA kernels for Hopper and their plain PyTorch versions.

Kernels are built and loaded at first launch, never at import."""
