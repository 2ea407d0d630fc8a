"""Per-layer metric readers, one file per metric of ``BENCHMARK.json``:
``read(ctx)`` returns the value, or None when the run holds nothing to
read."""
