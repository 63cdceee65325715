"""The program's own spans and counters (moonrtx_tpu_torch/utils/profiling.py)
against the harness: its spans are operator ranges, which
``harness/trace.py::collect`` passes over, so every reading of a traced
run is what it was without them; and the reader of the counters' metric."""

from types import SimpleNamespace

import pytest
import torch

from harness import spec, trace

CUDA = torch.autograd.DeviceType.CUDA
CPU = torch.autograd.DeviceType.CPU


class Event:
    """The parts of a profiler event that collect reads."""

    def __init__(self, name, start_us, dur_us, on_card=False, user=False):
        self._name, self._s, self._d = name, start_us, dur_us
        self._dev, self._user = (CUDA if on_card else CPU), user

    def name(self):
        return self._name

    def start_ns(self):
        return int(self._s * 1e3)

    def duration_ns(self):
        return int(self._d * 1e3)

    def device_type(self):
        return self._dev

    def is_user_annotation(self):
        return self._user


def profiler(events):
    results = SimpleNamespace(events=lambda: list(events))
    return SimpleNamespace(profiler=SimpleNamespace(kineto_results=results))


BENCH = [
    Event("pb.window", 0, 1000, user=True),
    Event("pb.session.event", 10, 40, user=True),
    Event("pb.session.frame", 50, 600, user=True),
    Event("pb.session.frame", 60, 500, on_card=True, user=True),
    Event("aten::add", 70, 5),
    Event("cudaLaunchKernel", 71, 2),
    Event("elementwise_kernel", 80, 100, on_card=True),
    Event("extract_level_kernel", 300, 40, on_card=True),
    Event("Memcpy DtoH", 520, 40, on_card=True),
]
# what a traced run of the program adds: its spans, as the profiler
# records them (operator ranges on the host, nothing on the card)
PROGRAM = [
    Event("moonrtx.session.event", 12, 30),
    Event("moonrtx.scene.update_view", 14, 20),
    Event("moonrtx.session.frame", 52, 590),
    Event("moonrtx.scene.sample", 55, 200),
    Event("moonrtx.scene.pose", 260, 30),
    Event("moonrtx.scene.display", 500, 100),
]


def readings(t):
    return dict(device=t.device, on_device=t.on_device, host=t.host,
                window=t.window, busy=t.busy_s(), idle=t.idle_share(),
                gaps=t.idle_gaps(), top=t.top_ops(),
                frame=t.device_ms("session.frame"),
                kernel=t.kernel_ms("extract_level_kernel"))


def test_collect_reads_the_same_with_the_program_spans():
    without = trace.collect(profiler(BENCH))
    mixed = BENCH[:3] + PROGRAM[:2] + BENCH[3:] + PROGRAM[2:]
    with_spans = trace.collect(profiler(mixed))
    assert readings(with_spans) == readings(without)
    t = with_spans
    assert not any(n.startswith("moonrtx.") for _, _, n in t.device)
    assert not any(k.startswith("moonrtx.") for k in t.host)
    assert not any(n.startswith("moonrtx.") for n, _ in t.top_ops())


def test_program_spans_are_not_user_annotations():
    from torch.profiler import ProfilerActivity, profile

    from moonrtx_tpu_torch.utils import profiling

    @profiling.span("test.decorated")
    def work(x):
        return x + 1

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.span("test.block"):
            work(torch.ones(4))
    events = [e for e in prof.profiler.kineto_results.events()
              if e.name().startswith("moonrtx.")]
    assert sorted(e.name() for e in events) == ["moonrtx.test.block",
                                                "moonrtx.test.decorated"]
    assert not any(e.is_user_annotation() for e in events)


@pytest.mark.parametrize("hit,miss,want", [(0, 0, None), (1, 3, 25.0),
                                           (5, 0, 100.0)])
def test_flip_hit_share_reads_the_counters(monkeypatch, hit, miss, want):
    from moonrtx_tpu_torch.utils import profiling

    read = spec.reader("scene.flip_hit_share.step")
    counts = {"flip.hit": hit, "flip.miss": miss} if hit + miss else {}
    monkeypatch.setattr(profiling, "counters", lambda: dict(counts))
    assert read(SimpleNamespace(on_card=True)) == want
    # off the card, as the harness's other counters, it reads nothing
    assert read(SimpleNamespace(on_card=False)) is None


def test_flip_hit_share_reads_nothing_from_a_program_without_counters(
        monkeypatch):
    from moonrtx_tpu_torch.utils import profiling

    read = spec.reader("scene.flip_hit_share.step")
    monkeypatch.delattr(profiling, "counters")
    assert read(SimpleNamespace(on_card=True)) is None
