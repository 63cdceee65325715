"""Lunar feature database: parser and built-in catalog.

Parses the same ':'-separated format as the reference feature CSV
(reference data_loader.py:51-112; format doc in its data/moon_features.csv
header): name:lat:lon:diameter_km:standard_label:spot_label:status_bar
[:usgs_id][:url]. Handles the Unicode minus sign. An external CSV can be
supplied via ``--features-file`` and loads through this parser.

The BUILT-IN catalog ships as columnar JSON (features_builtin.json):
4,488 lunar features — craters, maria, montes, rimae, valles, landing
sites — from the public-domain IAU Gazetteer of Planetary Nomenclature
(USGS Astrogeology), with the same standard-label (36), spot-label (22)
and status-bar (4,442) flag assignments as the reference catalog so
labels, search and mouse-over lookup have full parity out of the box.
"""

from __future__ import annotations

import json
import os
from typing import Optional

from moonrtx_tpu_torch import constants as C
from moonrtx_tpu_torch.types import MoonFeature

BUILTIN_FEATURES_PATH = os.path.join(os.path.dirname(__file__), "features_builtin.json")


def parse_feature_line(line: str) -> Optional[MoonFeature]:
    line = line.strip()
    if not line or line.startswith("#"):
        return None
    parts = line.split(":")
    if len(parts) < 7:
        return None
    name = parts[0].strip()
    try:
        lat = float(parts[1].strip().replace("−", "-"))
        lon = float(parts[2].strip().replace("−", "-"))
        diameter_km = float(parts[3].strip())
        feature_id_str = parts[7].strip() if len(parts) >= 8 else ""
        www = parts[8].strip() if len(parts) >= 9 else ""
        return MoonFeature(
            name=name,
            lat=lat,
            lon=lon,
            angular_radius=diameter_km / C.FEATURE_KM_PER_DEG,
            diameter_km=diameter_km,
            standard_label=parts[4].strip().lower() == "true",
            spot_label=parts[5].strip().lower() == "true",
            status_bar=parts[6].strip().lower() == "true",
            feature_id=int(feature_id_str) if feature_id_str else None,
            www_address=www or None,
        )
    except ValueError as e:
        print(f"Warning: Could not load Moon feature named {name}: {e}")
        return None


def load_builtin_features() -> list[MoonFeature]:
    """The built-in columnar-JSON catalog (4,488 IAU nomenclature entries).

    flags bitfield: 4 = standard label, 2 = spot label, 1 = status bar.
    """
    try:
        with open(BUILTIN_FEATURES_PATH, "r", encoding="utf-8") as f:
            d = json.load(f)
    except Exception as e:
        print(f"Warning: Could not load built-in Moon features: {e}")
        return []
    out = []
    for name, lat, lon, diam, flags, fid, www in zip(
            d["name"], d["lat"], d["lon"], d["diameter_km"], d["flags"],
            d["usgs_id"], d["www"]):
        out.append(MoonFeature(
            name=name, lat=lat, lon=lon,
            angular_radius=diam / C.FEATURE_KM_PER_DEG,
            diameter_km=diam,
            standard_label=bool(flags & 4),
            spot_label=bool(flags & 2),
            status_bar=bool(flags & 1),
            feature_id=fid, www_address=www))
    return out


def load_moon_features(filepath: Optional[str] = None) -> list[MoonFeature]:
    """Load features from ``filepath``, falling back to the built-in catalog.

    Missing or unreadable files produce a warning and the built-in catalog
    (the reference returns an empty list, data_loader.py:69-71; shipping a
    catalog keeps search/labels/status-bar functional out of the box).
    """
    if filepath is None:
        return load_builtin_features()
    if not os.path.isfile(filepath):
        print(f"Warning: Moon features file {filepath} was not found.")
        return load_builtin_features()
    features = []
    try:
        with open(filepath, "r", encoding="utf-8") as f:
            for line in f:
                feat = parse_feature_line(line)
                if feat is not None:
                    features.append(feat)
    except Exception as e:
        print(f"Warning: Could not load Moon features file: {e}")
    return features
