"""rays.roofline.step's count against a hand count on small calls of the
port's ray setup, and its reader on a program without the ray-setup
kernel."""

import importlib.util
import math

import pytest
import torch

from harness import roofline, spec


def reader():
    path = spec.ROOT / "portbench" / "metrics" / "rays.roofline.step.py"
    s = importlib.util.spec_from_file_location("rays_roofline_step", path)
    mod = importlib.util.module_from_spec(s)
    s.loader.exec_module(mod)
    return mod


def tiny_call(bound: str, image_dirs: bool):
    """A 16x32 frame of four blocks looking at the Moon from 30 radii: its
    chord bound from a 4x8 max map, a cached one, or none."""
    from moonrtx_tpu_torch.engine.camera import CameraBasis

    eye = torch.tensor([0.0, -300.0, 0.0])
    basis = CameraBasis(eye=eye, forward=torch.tensor([0.0, 1.0, 0.0]),
                        right=torch.tensor([1.0, 0.0, 0.0]),
                        up=torch.tensor([0.0, 0.0, 1.0]),
                        tan_half_fov=torch.tensor(math.tan(0.03)))
    call = dict(basis=basis, rotation=torch.eye(3), jitter=torch.zeros(2),
                height=16, width=32, h_min=0.95, maxmap=None, h_bound=None,
                row_offset=0, full_height=None, image_dirs=image_dirs)
    if bound == "maxmap":
        call["maxmap"] = torch.full((4, 8), 0.99)
    elif bound == "cached":
        call["h_bound"] = torch.full((4,), 0.99)
    return call


@pytest.mark.parametrize("image_dirs", [True, False])
@pytest.mark.parametrize("bound", ["maxmap", "cached", "none"])
def test_rays_count_by_hand(bound, image_dirs):
    mod = reader()
    call = tiny_call(bound, image_dirs)
    by, ops = mod.count(call)
    n, nblk = 512, 4
    want_by = n * (33 if image_dirs else 21)
    want_ops = n * (25 + 15 + 32 + 7) + nblk * 2
    want_ops += 6 * (16 + 32) if image_dirs else 12 * n
    if bound != "none":
        want_ops += 21 * n
        want_by += 4 * nblk
    if bound == "cached":
        want_ops += 4 * nblk
    if bound == "maxmap":
        texels = mod.texels(call)
        # the 384 samples of the four blocks' chords, through the middle
        # of the near hemisphere, land on some of the map's 32 texels; each
        # counts once
        assert 1 < texels < 32
        want_by += 4 * texels
        want_ops += nblk * (96 * 38 + 5)
    assert (by, ops) == (want_by, want_ops)


class _Trace:
    def __init__(self, ms):
        self.ms = ms

    def kernel_ms(self, name):
        return self.ms if name == "ray_setup_kernel" else 0.0


class _Ctx:
    def __init__(self, probe, window_ms=0.0, launches=()):
        self._p = probe
        self.trace = _Trace(window_ms)
        self.launches = list(launches)

    def probe(self):
        return self._p


def test_rays_reader_shares_and_is_silent_without_the_kernel():
    mod = reader()
    call = tiny_call("maxmap", True)
    least = roofline.least_ms(*mod.count(call))
    got = mod.read(_Ctx({"calls": [("block_rays", call)],
                         "trace": _Trace(4 * least)}))
    assert got == pytest.approx(25.0)
    # the probe's trace lost the kernel: the window's time per launch (4
    # launches over 3 requests)
    window = [{"block_rays": 1}, {"block_rays": 2, "blocked_sample": 2},
              {"block_rays": 1}]
    got = mod.read(_Ctx({"calls": [("block_rays", call)],
                         "trace": _Trace(0.0)}, 4 * 2 * least, window))
    assert got == pytest.approx(50.0)
    assert mod.read(_Ctx({"calls": [("block_rays", call)],
                          "trace": _Trace(0.0)})) is None
    # the parent: a plain-torch ray setup, no call of the wrapper recorded
    assert mod.read(_Ctx({"calls": [("blocked_sample", {})],
                          "trace": _Trace(0.0)})) is None
    assert mod.read(_Ctx(None)) is None
