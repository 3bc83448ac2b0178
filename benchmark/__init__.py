"""Benchmark of ssdseglib_torch on an NVIDIA GPU (see README.md)."""
