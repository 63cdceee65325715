"""The comparison that decides ``correct``.

For each checked request (drawn from the seed, traffic.checked_indices)
the frame the user saw and the hit buffer behind it are compared with the
plain reference's (reference/frame.py) for the same view, worked out from
the requests alone (program.view_states). Five numbers, the first four
each the worst over the checked requests:

* ``frame_mean_d``: the mean over pixels of the largest channel
  difference, in uint8 levels;
* ``frame_over8``: the share of pixels whose largest channel difference
  exceeds 8 levels;
* ``hit_mismatch``: the share of pixels that hit the Moon on one side and
  miss it on the other;
* ``lit_share_d``: the difference of the shares of pixels brighter than
  LIT levels (the sunlit Moon), which moves with the terminator;
* ``change_missed``: of what the checked requests changed in the
  reference's frames (the pixels that differ by more than 8 levels from
  the reference's frame of the view before), the share the program's
  frames still miss: the difference to the reference there, summed over
  the requests, over the change, summed alike. Frames that are right read
  near 0, frames one request stale near 1. Pooled, so that a request
  that changes few pixels weighs little; one that changes less than
  MIN_CHANGED of the frame is not read.

A configuration's ``check`` gives the limits of the numbers it holds its
cells to; ``correct`` needs every one of them.

The reference renders the samples the request asked for with the
program's own jitters: the run reads the state of the program's generator
(program.*User.rng_state) before each request, keeps the one before the
last request that drew from it (the one that rendered the frame on show:
a gamma change re-displays the last accumulation), and the check draws
the jitters again from it as the port documents its draws
(engine/scene.py::_padded_jitters: sample 0 at the pixel centres, then
``random((n - 1, 2)) - 0.5``), so the sampling noise cancels. (It does
not make a view that left out half of its samples show: PERF.md.)
"""

from __future__ import annotations

import numpy as np

NAMES = ("frame_mean_d", "frame_over8", "hit_mismatch", "lit_share_d",
         "change_missed")
LIT = 48            # uint8 level: above it a pixel counts as sunlit
OVER = 8            # uint8 levels: a pixel differs
MIN_CHANGED = 1e-4  # share of the frame a request must change to be read


def _diff(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return np.abs(a.astype(np.int16) - b.astype(np.int16)).max(-1)


def compare(frame, hit, ref_frame, ref_hit, prev_frame) -> dict:
    """The first four numbers for one request, and under ``change`` its
    part of change_missed: (levels missed, levels changed) summed over the
    pixels the request changed, or None where it changed too little to
    read; ``prev_frame`` is the reference's frame of the view before."""
    d = _diff(frame, ref_frame)
    lit = (frame.max(-1) > LIT).mean() - (ref_frame.max(-1) > LIT).mean()
    moved = _diff(prev_frame, ref_frame)
    changed = moved > OVER
    return dict(frame_mean_d=float(d.mean()),
                frame_over8=float((d > OVER).mean()),
                hit_mismatch=float(((hit[..., 3] > 0)
                                    != (ref_hit[..., 3] > 0)).mean()),
                lit_share_d=float(abs(lit)),
                change=((float(d[changed].sum()), float(moved[changed].sum()))
                        if changed.mean() >= MIN_CHANGED else None))


def pooled(parts) -> float:
    """change_missed from the requests' (missed, changed) parts (None: not
    read); 0 where no request changed enough to read."""
    read = [c for c in parts if c is not None]
    changed = sum(c[1] for c in read)
    return sum(c[0] for c in read) / changed if changed else 0.0


def jitters(samples: int, state: dict) -> np.ndarray:
    """The request's ``samples`` jitters, drawn from the program's generator
    state as engine/scene.py::_padded_jitters draws them."""
    j = np.zeros((samples, 2), np.float32)
    if samples > 1:
        g = np.random.Generator(getattr(np.random, state["bit_generator"])())
        g.bit_generator.state = state
        j[1:] = g.random((samples - 1, 2)) - 0.5
    return j


def reference_scene(cfg: dict, maps: dict, device, dtype=None):
    import torch

    from reference.frame import ReferenceScene

    return ReferenceScene(cfg["render"], cfg["observer"], maps["elevation"],
                          maps["radius_scale"], maps["albedo"],
                          maps["starmap"], device,
                          dtype=torch.float32 if dtype is None else dtype)


def judge(cfg: dict, mix: dict, checked: list, views: list, maps: dict,
          device, control: bool = False) -> tuple:
    """Compare each checked request's (frame, hit) with the reference.

    checked: [(k, frame, hit, generator state)] with k the request's index
    in ``views`` (program.view_states: the first view, then one after
    each request, warm-up first). Returns ({name: worst value, "n":
    requests compared}, the same for the control or None). The control is
    the reference in bfloat16 (reference/frame.py), put in the program's
    place for the same requests and jitters."""
    import torch

    ref = reference_scene(cfg, maps, device)
    ctl = (reference_scene(cfg, maps, device, dtype=torch.bfloat16)
           if control else None)
    samples = int(mix["samples"])
    got, got_ctl = [], []
    for k, frame, hit, state in checked:
        j = jitters(samples, state)
        rf, rh = ref.render(views[k], j)
        pf, _ = ref.render(views[k - 1], j)
        got.append(compare(frame, hit, rf, rh, pf))
        if ctl is not None:
            cf, ch = ctl.render(views[k], j)
            got_ctl.append(compare(cf, ch, rf, rh, pf))
    ref.close()
    return (_readings(got),
            _readings(got_ctl) if ctl is not None else None)


def _readings(per_request: list) -> dict:
    out = {k: max((r[k] for r in per_request), default=0.0)
           for k in NAMES[:4]}
    out["change_missed"] = pooled(r["change"] for r in per_request)
    out["n"] = len(per_request)
    return out


def verdict(readings: dict, limits: dict) -> bool:
    """Every number the configuration limits is within its limit, over at
    least one request."""
    unknown = set(limits) - set(NAMES)
    if unknown:
        raise KeyError(f"no such check: {sorted(unknown)}")
    return (readings["n"] > 0 and bool(limits)
            and all(readings[k] <= limits[k] for k in limits))
