"""Benchmark of the PyTorch/CUDA port (``repro_torch``): Treant dashboards
on one GPU.  ``python3 treantbench/run.py --workload <cell> ...`` runs one
cell of ``BENCHMARK.json``; see ``treantbench/README.md``."""
