"""Frozen copies of moonrtx_tpu_torch/interact modules (see each file)."""
