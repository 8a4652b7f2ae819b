"""The benchmark of the PyTorch and CUDA port (``repro_torch``).

``python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints its
result as the last line of standard output. Everything that belongs to
one configuration, traffic mix, cell or per-layer metric is a file of
its own under ``configs/``, ``traffic/``, ``workloads/`` and
``metrics/``, found by its name; the yardstick (generators, peaks, byte
and FLOP counts, plain references, comparisons) lives under
``harness/`` and ``reference/``.
"""
