"""Hand-written CUDA kernels for Hopper (the counterpart of tpuvo/ops/pallas/)."""
