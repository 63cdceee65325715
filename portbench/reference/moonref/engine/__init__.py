"""Frozen copies of moonrtx_tpu_torch/engine modules (see each file)."""
