"""PlaneRecNet in PyTorch with hand-written CUDA kernels for Hopper.

The port of the JAX package ``planerecnet_tpu`` (the reference it is tested
against), module for module. It imports nothing of that package. Entry
point: ``planerecnet_tpu_torch.runner.PlaneRecNetRunner``.
"""
