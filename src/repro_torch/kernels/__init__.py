"""Hand-written CUDA kernels for Hopper, their plain PyTorch versions, and
the device-dispatching wrappers (`kernels.ops`)."""
