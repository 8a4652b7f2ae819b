"""The LM side of the port: architecture configs, layers, attention, the
block stack and the LM wrapper with the serving step builders, and the
converter that carries the JAX package's weights across."""
