"""Plain PyTorch references that decide ``correct``.

Nothing here imports ``repro_torch`` or the JAX package: where the
program's arithmetic is the definition (the counters, the energy
model), a frozen copy is kept, and each file's header names what it was
copied from.
"""
