"""Hand-written CUDA kernels for the H100 (sources in ``csrc/``) and the
wrappers that dispatch between each kernel and its plain PyTorch version."""
