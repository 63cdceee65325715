"""Data ingest, caching, procedural synthesis, mip pyramids, the feature
catalog (host, numpy)."""

from moonrtx_tpu_torch.data.features import load_moon_features, parse_feature_line
from moonrtx_tpu_torch.data.loader import (
    load_color_data,
    load_elevation_data,
    load_starmap,
)
from moonrtx_tpu_torch.data.mips import block_mean, build_mips, pad_lon_wrap, select_level

__all__ = [
    "load_moon_features",
    "parse_feature_line",
    "load_elevation_data",
    "load_color_data",
    "load_starmap",
    "block_mean",
    "build_mips",
    "pad_lon_wrap",
    "select_level",
]
