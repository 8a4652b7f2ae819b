"""Applications of the SA power model (the paper's CNN evaluation)."""
