"""Faults planted in the program, which the check must catch.

Each is a patch of the port's classes for the length of a ``with
planted(name):`` block. The tests plant them at a size a CPU test holds
(tests/test_portbench_check.py); portbench/control.py plants them on the
card at a cell's own size.

* ``frozen_clock``: the scene keeps its date whatever a request asks (a
  step that returns its state unchanged);
* ``stale``: the scene shows the frame of the request before (a display
  one request behind);
* ``half_burst``: a view accumulates half of the samples it asked for;
* ``dimmed``: the frame is dimmed by 10% where it is produced.
"""

from __future__ import annotations

import contextlib

import numpy as np

FAULTS = ("frozen_clock", "stale", "half_burst", "dimmed")


def _patches(name: str, MoonScene) -> dict:
    display = MoonScene.display
    if name == "frozen_clock":
        update = MoonScene.update_view
        return {"update_view": lambda self, dt_local=None: update(self, None)}
    if name == "stale":
        def stale(self):
            img = display(self)
            shown = getattr(self, "_faults_shown", img)
            self._faults_shown = img
            return shown
        return {"display": stale}
    if name == "half_burst":
        ensure = MoonScene.ensure_accumulated

        def half(self, n_frames=None):
            n = self.config.accumulation_frames if n_frames is None \
                else n_frames
            return ensure(self, max(1, n // 2))
        return {"ensure_accumulated": half}
    if name == "dimmed":
        def dimmed(self):
            return (display(self).astype(np.float32) * 0.9).astype(np.uint8)
        return {"display": dimmed}
    raise ValueError(f"unknown fault {name!r} (have: {', '.join(FAULTS)})")


@contextlib.contextmanager
def planted(name: str):
    from moonrtx_tpu_torch.engine.scene import MoonScene

    patches = _patches(name, MoonScene)
    saved = {k: MoonScene.__dict__[k] for k in patches}
    try:
        for k, fn in patches.items():
            setattr(MoonScene, k, fn)
        yield
    finally:
        for k, fn in saved.items():
            setattr(MoonScene, k, fn)
