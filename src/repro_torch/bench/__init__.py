"""The port's benchmarks: ``python -m repro_torch.bench.<name>``, each
printing ``name,us_per_call,derived`` CSV rows (the JAX package's
``benchmarks/`` convention) and, with ``--emit-json``, a structured
artifact checked by ``tools/check_bench_schema.py``."""
