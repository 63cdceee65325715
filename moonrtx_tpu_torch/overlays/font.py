"""Vector stroke font for in-scene overlay text.

An original single-stroke font on a 4x6 design grid (A-Z, 0-9 and the
punctuation the overlays need), normalized to width 0.6 / height 1.0 per
unit scale. Fills the same role as the reference's stroke tables
(moon_grid.py:46-139) for grid numbers, feature labels and pin digits.
"""

from __future__ import annotations

import numpy as np

# Each glyph: list of polylines; points on a 4 (x) by 6 (y) grid.
_GLYPHS: dict[str, list[list[tuple]]] = {
    "A": [[(0, 0), (2, 6), (4, 0)], [(1, 2), (3, 2)]],
    "B": [[(0, 0), (0, 6), (3, 6), (4, 5), (4, 3.6), (3, 3), (0, 3)],
          [(3, 3), (4, 2.4), (4, 1), (3, 0), (0, 0)]],
    "C": [[(4, 1), (3, 0), (1, 0), (0, 1), (0, 5), (1, 6), (3, 6), (4, 5)]],
    "D": [[(0, 0), (0, 6), (2.5, 6), (4, 4.5), (4, 1.5), (2.5, 0), (0, 0)]],
    "E": [[(4, 0), (0, 0), (0, 6), (4, 6)], [(0, 3), (3, 3)]],
    "F": [[(0, 0), (0, 6), (4, 6)], [(0, 3), (3, 3)]],
    "G": [[(4, 5), (3, 6), (1, 6), (0, 5), (0, 1), (1, 0), (3, 0), (4, 1),
           (4, 3), (2.5, 3)]],
    "H": [[(0, 0), (0, 6)], [(4, 0), (4, 6)], [(0, 3), (4, 3)]],
    "I": [[(1, 0), (3, 0)], [(2, 0), (2, 6)], [(1, 6), (3, 6)]],
    "J": [[(3, 6), (3, 1), (2, 0), (1, 0), (0, 1)]],
    "K": [[(0, 0), (0, 6)], [(4, 6), (0, 2.5)], [(1.5, 3.6), (4, 0)]],
    "L": [[(0, 6), (0, 0), (4, 0)]],
    "M": [[(0, 0), (0, 6), (2, 3), (4, 6), (4, 0)]],
    "N": [[(0, 0), (0, 6), (4, 0), (4, 6)]],
    "O": [[(1, 0), (0, 1), (0, 5), (1, 6), (3, 6), (4, 5), (4, 1), (3, 0),
           (1, 0)]],
    "P": [[(0, 0), (0, 6), (3, 6), (4, 5), (4, 3.6), (3, 2.8), (0, 2.8)]],
    "Q": [[(1, 0), (0, 1), (0, 5), (1, 6), (3, 6), (4, 5), (4, 1), (3, 0),
           (1, 0)], [(2.5, 1.5), (4.2, -0.4)]],
    "R": [[(0, 0), (0, 6), (3, 6), (4, 5), (4, 3.6), (3, 2.8), (0, 2.8)],
          [(2, 2.8), (4, 0)]],
    "S": [[(4, 5), (3, 6), (1, 6), (0, 5), (0, 4), (4, 2), (4, 1), (3, 0),
           (1, 0), (0, 1)]],
    "T": [[(0, 6), (4, 6)], [(2, 6), (2, 0)]],
    "U": [[(0, 6), (0, 1), (1, 0), (3, 0), (4, 1), (4, 6)]],
    "V": [[(0, 6), (2, 0), (4, 6)]],
    "W": [[(0, 6), (1, 0), (2, 4), (3, 0), (4, 6)]],
    "X": [[(0, 0), (4, 6)], [(0, 6), (4, 0)]],
    "Y": [[(0, 6), (2, 3), (4, 6)], [(2, 3), (2, 0)]],
    "Z": [[(0, 6), (4, 6), (0, 0), (4, 0)]],
    "0": [[(0, 0), (0, 6), (4, 6), (4, 0), (0, 0)]],
    "1": [[(1, 5), (2, 6), (2, 0)], [(1, 0), (3, 0)]],
    "2": [[(0, 5), (1, 6), (3, 6), (4, 5), (4, 4), (0, 0), (4, 0)]],
    "3": [[(0, 6), (4, 6), (2, 3.6), (4, 2), (4, 1), (3, 0), (1, 0), (0, 1)]],
    "4": [[(3, 0), (3, 6), (0, 2), (4, 2)]],
    "5": [[(4, 6), (0, 6), (0, 3.6), (2.8, 3.6), (4, 2.4), (4, 1), (3, 0),
           (1, 0), (0, 1)]],
    "6": [[(3.5, 6), (1, 6), (0, 5), (0, 1), (1, 0), (3, 0), (4, 1), (4, 2),
           (3, 3), (0, 3)]],
    "7": [[(0, 6), (4, 6), (1.5, 0)]],
    "8": [[(1, 3), (0, 4), (0, 5), (1, 6), (3, 6), (4, 5), (4, 4), (3, 3),
           (1, 3), (0, 2), (0, 1), (1, 0), (3, 0), (4, 1), (4, 2), (3, 3)]],
    "9": [[(4, 3), (1, 3), (0, 4), (0, 5), (1, 6), (3, 6), (4, 5), (4, 1),
           (3, 0), (0.5, 0)]],
    "-": [[(1, 3), (3, 3)]],
    "'": [[(2, 6), (2, 5)]],
    "<": [[(3, 5), (1, 3), (3, 1)]],
    ">": [[(1, 5), (3, 3), (1, 1)]],
    ".": [[(2, 0), (2, 0.4)]],
    "/": [[(0, 0), (4, 6)]],
    " ": [],
}

# glyph box: x 0..4 -> width 0.6*scale centered, y 0..6 -> height 1.0*scale
_XS = 0.6 / 4.0
_YS = 1.0 / 6.0


def glyph_segments(char: str, scale: float = 1.0,
                   flip_horizontal: bool = False,
                   flip_vertical: bool = False) -> list[np.ndarray]:
    """2D stroke segments of a character, centered at the origin.

    Returns a list of (k, 2) arrays of consecutive points. Flips mirror the
    glyph for the telescope orientations so text stays readable.
    """
    polys = _GLYPHS.get(char.upper(), _GLYPHS.get(char, []))
    out = []
    for poly in polys:
        pts = np.asarray(poly, float)
        x = (pts[:, 0] - 2.0) * _XS * scale
        y = (pts[:, 1] - 3.0) * _YS * scale
        if flip_horizontal:
            x = -x
        if flip_vertical:
            y = -y
        out.append(np.column_stack([x, y]))
    return out


def text_segments(text: str, scale: float = 1.0, spacing: float = 0.15,
                  centered: bool = True, flip_horizontal: bool = False,
                  flip_vertical: bool = False) -> list[np.ndarray]:
    """2D strokes for a text string laid out along +x.

    With flip_horizontal the glyph order is reversed so mirrored text reads
    naturally (reference moon_grid.py:349-351 semantics)."""
    advance = (0.6 + spacing) * scale
    chars = text.upper()
    if flip_horizontal:
        chars = chars[::-1]
    n = len(chars)
    total = n * advance - spacing * scale
    segments = []
    for i, ch in enumerate(chars):
        cx = i * advance + 0.3 * scale - (total / 2.0 if centered else 0.0)
        for seg in glyph_segments(ch, scale, flip_horizontal, flip_vertical):
            seg = seg.copy()
            seg[:, 0] += cx
            segments.append(seg)
    return segments
