"""Hand-written CUDA attention kernels for Hopper, their plain PyTorch
versions, and the device dispatch between them (``ops``)."""
