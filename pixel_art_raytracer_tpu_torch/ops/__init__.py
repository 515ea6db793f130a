"""Tensor stages of the render path and the wrappers of its kernels."""
