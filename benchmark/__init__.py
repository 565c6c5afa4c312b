"""The benchmark of epidemicmodeling_torch on an NVIDIA H100 (README.md)."""
