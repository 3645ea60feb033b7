"""Ops: attention and the hand-written CUDA kernels behind it.

Each kernel lives in ``csrc/`` as CUDA C++ for Hopper, is built by
``_nvcc`` at first use, and has a plain PyTorch version in the same op
module that the CPU path runs and the kernel is checked against.
"""
