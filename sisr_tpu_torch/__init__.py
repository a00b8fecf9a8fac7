"""sisr_tpu_torch — the PyTorch/CUDA port of sisr_tpu for one NVIDIA H100.

The JAX package ``sisr_tpu`` is the reference; this package re-implements its
serving and training paths in PyTorch, with every TPU (Pallas) kernel
replaced by a hand-written CUDA kernel for ``sm_90a`` (sources in ``csrc/``,
built with ``nvcc`` at first use and bound through ctypes; gradients through
``torch.autograd.Function``s).  It never imports JAX.
"""
