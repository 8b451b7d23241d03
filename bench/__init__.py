"""Benchmark of the PyTorch and CUDA package `repro_torch` (see README.md)."""
