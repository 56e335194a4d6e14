"""Hand-written Hopper kernels (CUDA C++ under csrc/), their wrappers,
plain PyTorch versions and the dispatching entry points in ops."""
