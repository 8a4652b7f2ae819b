"""repro_torch -- the PyTorch/CUDA port of :mod:`repro`.

Mirrors the JAX package's layout (``core/``, ``kernels/``, ``design/``,
``apps/cnn/``) and public names, so each module has an obvious
counterpart. Plain tensor code is PyTorch; every Pallas TPU kernel of
the reference becomes a kernel written by hand for Hopper (``csrc/``),
with a plain PyTorch version beside it that the CPU runs.

Bus words are carried as ``int32`` tensors holding 0..65535: PyTorch's
CPU backend has no shifts on ``uint16`` and no popcount, so the port
counts bits with a SWAR popcount on 32-bit lanes.
"""
