"""Plain PyTorch references of the benchmark's configurations. They import
torch alone: neither jax, nor the JAX package, nor the program."""
