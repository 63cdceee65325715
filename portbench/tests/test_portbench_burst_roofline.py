"""burst.roofline.view's count against a hand count on a tiny recorded
call, and its reader on a program without the burst kernel."""

import importlib.util

import pytest
import torch

from harness import roofline, spec

G, B = 8, 128


def reader():
    path = spec.ROOT / "portbench" / "metrics" / "burst.roofline.view.py"
    s = importlib.util.spec_from_file_location("burst_roofline_view", path)
    mod = importlib.util.module_from_spec(s)
    s.loader.exec_module(mod)
    return mod


def tiny_call(h_bound=True):
    """Two strips; sample 0 hit 10 rays, all in strip 0."""
    plane = torch.zeros((2, G, B))
    f_prev = plane.clone()
    f_prev[0, 3, :10] = 1.0
    return dict(params=torch.zeros((27, G, B)), jitters=torch.zeros((32, 2)),
                h_bound=torch.ones(2 * G) if h_bound else None, r=plane,
                g=plane, b=plane, t_prev=plane, f_prev=f_prev,
                scal=torch.zeros((2, 10, G, B)),
                hwin=torch.zeros((2, G * 40, 64)),
                awin=torch.zeros((2, G * 40, 3 * 64)),
                swin=torch.zeros((2, G * 32, 2 * 48), dtype=torch.bfloat16),
                n_samples=4)


@pytest.mark.parametrize("with_bound", [True, False])
def test_burst_count_by_hand(with_bound):
    call = tiny_call(with_bound)
    by, ops = reader().count(call)
    plane = 2 * G * B * 4
    windows = (10 * G * B * 4 + G * 40 * 64 * 4 + G * 40 * 192 * 4
               + G * 32 * 96 * 2)                 # one strip's, f32 / bf16
    want = (27 * G * B * 4 + 4 * 2 * 4 + 8 * plane + windows
            + (2 * G * 4 if with_bound else 0))
    assert by == want
    assert ops == 3 * 760 * 10
    # a lower bound: at most every input read once and the mean written
    everything = sum(roofline.nbytes(v) for v in call.values()
                     if isinstance(v, torch.Tensor)) + 3 * plane
    assert by < everything
    assert ops < 3 * 760 * 2 * G * B


class _Trace:
    def __init__(self, ms):
        self.ms = ms

    def kernel_ms(self, name):
        return self.ms if name == "burst_kernel" else 0.0


class _Ctx:
    def __init__(self, probe):
        self._p = probe

    def probe(self):
        return self._p


def test_burst_reader_shares_and_is_silent_without_the_kernel():
    mod = reader()
    call = tiny_call()
    least = roofline.least_ms(*mod.count(call))
    got = mod.read(_Ctx({"calls": [("march_burst", call)],
                         "trace": _Trace(4 * least)}))
    assert got == pytest.approx(25.0)
    # the parent: K2 a sample, no burst call, no burst_kernel events
    assert mod.read(_Ctx({"calls": [("march_shade", {})],
                          "trace": _Trace(0.0)})) is None
    assert mod.read(_Ctx(None)) is None
