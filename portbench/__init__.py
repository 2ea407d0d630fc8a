"""The benchmark of echoseal_torch: ``python3 portbench/run.py --workload
<name> ...`` runs one cell of ``BENCHMARK.json`` once (see ``run.py``)."""
