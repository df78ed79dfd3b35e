"""PyTorch/CUDA port of the D-STACK serving data plane.

The JAX package ``repro`` is the reference; this package imports nothing
of it. Attention on the serving path runs hand-written CUDA kernels for
Hopper (``repro_torch.kernels``) on a CUDA device, and their plain PyTorch
versions on the CPU.
"""
