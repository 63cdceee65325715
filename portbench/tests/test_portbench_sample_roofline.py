"""sample.roofline.step's count against a hand count on a tiny recorded
call, and its reader on a program without the sample kernel."""

import importlib.util
from types import SimpleNamespace

import pytest
import torch

from harness import roofline, spec


def reader():
    path = spec.ROOT / "portbench" / "metrics" / "sample.roofline.step.py"
    s = importlib.util.spec_from_file_location("sample_roofline_step", path)
    mod = importlib.util.module_from_spec(s)
    s.loader.exec_module(mod)
    return mod


def tiny_call(shadows=True, bounce=True, lunar=True, earth=True):
    """An 8x32 frame of two blocks: block 0 has 100 rays with a chord,
    block 1 none; 10 rays hit, in block 0's first row, whose sigma is
    0.1."""
    live = torch.zeros((2, 128), dtype=torch.bool)
    live[0, :100] = True
    sw = None
    if shadows:
        sw = SimpleNamespace(swin=torch.zeros((2, 32, 96 if bounce else 48)))
    fp = SimpleNamespace(lunar_blend=torch.tensor(0.5) if lunar else None,
                         earth=torch.zeros(6) if earth else None)
    call = dict(geom=SimpleNamespace(hit_outer=live),
                org=SimpleNamespace(sigma=torch.tensor([0.1, 0.0])),
                shadow_windows=sw, fp=fp, height=8, width=32)
    hitbuf = torch.zeros((8, 32, 4))
    hitbuf[0, :10, 3] = 290.0
    return call, SimpleNamespace(hitbuf=hitbuf)


@pytest.mark.parametrize("shadows,bounce,lunar,earth", [
    (True, True, True, True), (True, False, True, True),
    (False, False, False, False)])
def test_sample_count_by_hand(shadows, bounce, lunar, earth):
    mod = reader()
    call, out = tiny_call(shadows, bounce, lunar, earth)
    by, ops = mod.count(call, out)
    # outputs and flag + direction of 256 rays, chord ends of 100, one
    # block's window and mean
    assert by == 256 * 41 + 100 * 8 + (2560 + 1) * 4
    assert (mod.FIELD, mod.COARSE, mod.BISECT, mod.NORMAL) == (72, 75, 77,
                                                               313)
    per_hit = 8 * 77 + 22 + 44 + 313 + 60 + 26 + 15
    per_hit += (76 + (21 if bounce else 0)) if shadows else 0
    per_hit += (14 if lunar else 0) + (111 if earth else 0)
    assert ops == 100 * 75 + 10 * (per_hit + 23)


class _Trace:
    def __init__(self, ms):
        self.ms = ms

    def kernel_ms(self, name):
        return self.ms if name == "blocked_sample_kernel" else 0.0


class _Ctx:
    def __init__(self, probe):
        self._p = probe

    def probe(self):
        return self._p


def test_sample_reader_shares_and_is_silent_without_the_kernel(monkeypatch):
    mod = reader()
    call, out = tiny_call()
    count = mod.count
    least = roofline.least_ms(*count(call, out))
    # the output the wrapper would give again on the card
    monkeypatch.setattr(mod, "count", lambda c: count(c, out))
    got = mod.read(_Ctx({"calls": [("blocked_sample", call)],
                         "trace": _Trace(4 * least)}))
    assert got == pytest.approx(25.0)
    # the parent: a plain-torch sample, no call of the wrapper recorded
    assert mod.read(_Ctx({"calls": [("extract_level_windows", {})],
                          "trace": _Trace(0.0)})) is None
    assert mod.read(_Ctx(None)) is None
