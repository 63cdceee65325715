"""The tiny cells through the card's kernels: a traced run reports every
per-layer metric of its cell, the check passes and its bfloat16 control
fails. Needs a CUDA card (``-m gpu``)."""

import time

import pytest

import tiny
from harness import cell, spec


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make_root(tmp_path_factory.mktemp("checkout"))


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["march.jump", "blocked.held"])
def test_tiny_traced_cell_on_the_card(card, root, name):
    r = cell.run_cell(name, 2**31 + 7, 3.0, True, time.perf_counter(),
                      root=root, control=True)
    assert r["correct"], r["checks"]
    assert not r["control_correct"], r["control"]
    dev = r["device"]
    assert dev["platform"] == "gpu" and dev["memory_peak_bytes"] > 0
    assert 0 < dev["busy_s"] <= dev["window_s"]
    _, layer = spec.metrics_of(spec.load_benchmark(root), name)
    assert set(r["metrics"]) == {m["name"] for m in layer}
    for m in layer:
        if m["unit"] == "%":
            assert 0 <= r["metrics"][m["name"]]["value"] <= 105
    assert len(r["breakdown"]["device_ops"]) <= 10
    assert len(r["breakdown"]["idle_gaps"]) <= 10
