"""hipims-tpu-torch: the PyTorch + CUDA port of hipims-tpu for NVIDIA H100.

A second package beside ``hipims_tpu`` (the JAX reference, which it never
imports).  Module paths mirror the JAX package; plain PyTorch functions on
tensors are the portable versions, and the fused step runs as a
hand-written CUDA kernel on the card (``csrc/``, ``ops/kernels/``).
"""

__version__ = "0.1.0"

from .state import DomainStatic, FlowState, StepCarry  # noqa: F401
