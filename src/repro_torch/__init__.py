"""PyTorch port of the NNCG engine: graph IR, executors, Hopper kernels,
sessions and serving, beside the JAX reference package."""
