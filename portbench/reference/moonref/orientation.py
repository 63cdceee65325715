# Frozen copy of moonrtx_tpu_torch/orientation.py at commit 41cfce49f52c, for the benchmark's
# plain reference, trimmed to what the reference reaches; imports renamed.
"""Telescope view orientation modes (reference view_orientation.py).

Each mode specifies (vertical_flip, horizontal_flip) of the rendered image:
vertical flip = south up, horizontal flip = east left.
"""

NSWE = "NSWE"  # default: N up, W left
NSEW = "NSEW"  # N up, E left (horizontal flip)
SNEW = "SNEW"  # S up, E left (both flips = 180 deg rotation)
SNWE = "SNWE"  # S up, W left (vertical flip)

VIEW_ORIENTATIONS = [NSWE, NSEW, SNEW, SNWE]
FLIP_HORIZONTAL = frozenset({NSEW, SNEW})
FLIP_VERTICAL = frozenset({SNEW, SNWE})


def flips(orientation: str) -> tuple[bool, bool]:
    """(flip_horizontal, flip_vertical) for an orientation mode."""
    return orientation in FLIP_HORIZONTAL, orientation in FLIP_VERTICAL
