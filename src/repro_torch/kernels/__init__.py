"""Hand-written CUDA kernels for Hopper (``csrc/``), their plain PyTorch
versions, the device pool and the device / build layer (``ops``)."""
