"""Hand-written CUDA kernels for Hopper (the port of ops/pallas/), built from
csrc/ at first use; see build.py."""
