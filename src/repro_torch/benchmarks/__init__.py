"""Benchmarks of the port (the paper's tables, run through ``repro_torch``)."""
