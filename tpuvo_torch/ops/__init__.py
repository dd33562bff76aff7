"""Geometry and compute ops on tensors (twins of tpuvo/ops)."""
