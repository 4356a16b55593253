"""Shallow-water operators as plain PyTorch functions on tensors.

These are the port's plain versions: they run on any device and are what
the CPU tests hold against the JAX package.  ``ops/kernels`` holds the
hand-written CUDA kernels that replace them on the card.
"""
