"""Data parallelism over a ``torch.distributed`` process group (``mesh``)
and the multi-rank TX -> RX dry run (``python -m
echoseal_torch.parallel.dryrun N``)."""
