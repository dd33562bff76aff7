"""Observability, checkpointing, validation and profiling utilities (twins of tpuvo/utils)."""
