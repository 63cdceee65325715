"""bounce.roofline.view's count against a hand count on a small grid, and
its reader on a program without the bounce kernels."""

import importlib.util

import pytest
import torch

from harness import roofline, spec


def reader():
    path = spec.ROOT / "portbench" / "metrics" / "bounce.roofline.view.py"
    s = importlib.util.spec_from_file_location("bounce_roofline_view", path)
    mod = importlib.util.module_from_spec(s)
    s.loader.exec_module(mod)
    return mod


def small_call(n_bounces=1):
    """A 64x128 scan grid: three levels of 8192, 2048 and 512 cells."""
    plane = torch.zeros((64, 128))
    return dict(hs=plane, factor=plane, alb_s=plane, n_coarse=32,
                n_fine=32, n_phi=128, n_bounces=n_bounces)


@pytest.mark.parametrize("n_bounces", [1, 2])
def test_bounce_count_by_hand(n_bounces):
    mod = reader()
    assert mod.levels(64, 128) == 3 and mod.levels(1536, 4096) == 7
    by, ops = mod.count(small_call(n_bounces))
    # hs, factor, alb_s and the map; levels 1-2: heights, maxima, and the
    # radiosity of each bounce
    assert by == (4 * 8192 * 4) + (2048 + 512) * 4 * (2 + n_bounces)
    # a bounce: sectors and blur on every level (8 * 15 + 12 a cell), the
    # collapse on levels 0-1 (16 * 6 + 8), decimation on levels 1-2 (11),
    # level 0's sum (18); n.l once (20); the second bounce's product and
    # sum (2)
    per_bounce = (10752 * 132 + 10240 * 104 + 2560 * 11 + 8192 * 18)
    assert per_bounce == 2659840
    assert ops == n_bounces * per_bounce + 8192 * 20 + (n_bounces - 1) \
        * 8192 * 2


class _Trace:
    def __init__(self, ms):
        self.ms = ms

    def kernel_ms(self, name):
        return self.ms if name == "bounce_" else 0.0


class _Ctx:
    def __init__(self, probe):
        self._p = probe

    def probe(self):
        return self._p


def test_bounce_reader_shares_and_is_silent_without_the_kernels():
    mod = reader()
    call = small_call()
    least = roofline.least_ms(*mod.count(call))
    got = mod.read(_Ctx({"calls": [("bounce_from_parts", call)],
                         "trace": _Trace(5 * least)}))
    assert got == pytest.approx(20.0)
    # the parent: a plain-torch pyramid, no call of the wrapper recorded
    assert mod.read(_Ctx({"calls": [("shadow_factor", {})],
                          "trace": _Trace(0.0)})) is None
    assert mod.read(_Ctx(None)) is None
