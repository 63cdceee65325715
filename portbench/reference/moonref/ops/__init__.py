"""Frozen copies of moonrtx_tpu_torch/ops modules (see each file)."""
