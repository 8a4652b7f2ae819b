"""Per-site power registry and paper-style reports. The serving engine
books each retired request's counters here (``capture``) and builds its
serve-wide report from them (``report``). The model-wide tracer that
feeds the same registry from a model's own matmuls is ROADMAP step 6."""
