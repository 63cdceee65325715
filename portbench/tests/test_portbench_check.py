"""The check that decides ``correct``: its control and the faults it must
catch, at a size a CPU test run holds (the tiny cells of tiny.py). The
same control runs on the card at each cell's own size through
portbench/control.py; PERF.md gives those readings and the limits."""

import time

import numpy as np
import pytest

import tiny
from harness import cell, check, faults

SEED = 31337


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make_root(tmp_path_factory.mktemp("checkout"))


def run(root, name, **kw):
    return cell.run_cell(name, SEED, 3.0, False, time.perf_counter(),
                         root=root, device="cpu", **kw)


@pytest.mark.parametrize("name", ["march.jump", "blocked.held"])
def test_control_in_bfloat16_fails(root, name):
    r = run(root, name, control=True)
    assert r["correct"], r["checks"]
    assert not r["control_correct"], r["control"]
    for k in check.NAMES:
        # the control reads at least three times what the program does
        assert r["control"][k] >= 3 * r["checks"][k]["value"]
    assert list(r)[-1] == "checks"


# the faults of harness/faults.py that the check catches in each cell (a
# view that accumulates half of its samples it does not: PERF.md)
@pytest.mark.parametrize("name,fault", [
    ("march.jump", "frozen_clock"), ("blocked.held", "frozen_clock"),
    ("march.jump", "stale"), ("blocked.held", "stale"),
    ("march.jump", "dimmed"), ("blocked.held", "dimmed")])
def test_a_planted_fault_is_caught(root, name, fault):
    with faults.planted(fault):
        r = run(root, name)
    assert not r["correct"], r["checks"]


def test_a_time_step_that_leaves_the_state_unchanged_is_caught(
        root, monkeypatch):
    from moonrtx_tpu_torch.app.session import Session

    monkeypatch.setattr(Session, "change_time", lambda self, d: None)
    assert not run(root, "blocked.held")["correct"]


def test_faults_leave_the_program_as_it_was(root):
    from moonrtx_tpu_torch.engine.scene import MoonScene

    before = dict(vars(MoonScene))
    for f in faults.FAULTS:
        with faults.planted(f):
            pass
    assert dict(vars(MoonScene)) == before
    with pytest.raises(ValueError):
        with faults.planted("no_such_fault"):
            pass


def test_compare_by_hand():
    a = np.zeros((2, 5, 3), np.uint8)
    b = a.copy()
    b[0, 0] = (0, 9, 1)            # largest channel difference 9: over 8
    b[1, 4] = (3, 0, 0)
    b[1, 0] = (60, 60, 60)         # lit on one side only
    ha = np.zeros((2, 5, 4), np.float32)
    hb = ha.copy()
    hb[0, 1, 3] = 5.0              # one pixel hits on one side only
    prev = b.copy()
    prev[1, 0] = (0, 0, 0)         # the request lit this pixel: 60 levels
    prev[0, 2] = (20, 0, 0)        # and dimmed this one by 20 (a is 0 here)
    got = check.compare(a, ha, b, hb, prev)
    # a misses 60 of the 60 levels at [1, 0]; at [0, 2] it equals b
    assert got == pytest.approx({"frame_mean_d": 7.2, "frame_over8": 0.2,
                                 "hit_mismatch": 0.1, "lit_share_d": 0.1,
                                 "change": (60, 80)})
    # a request that changes nothing is not read
    assert check.compare(a, ha, b, hb, b)["change"] is None
    assert check.compare(b, hb, b, hb, a)["change"] == (0, 69)


def test_change_missed_pools_the_requests():
    # a request that changed little weighs little; one not read, nothing
    assert check.pooled([(60, 80), None, (1, 2)]) == pytest.approx(61 / 82)
    assert check.pooled([None, None]) == 0.0
    assert check.pooled([]) == 0.0


def test_jitters_are_the_programs_draws():
    import numpy as np

    g = np.random.default_rng(42)
    g.random(7)
    state = g.bit_generator.state
    want = np.zeros((32, 2), np.float32)
    want[1:] = g.random((31, 2)) - 0.5
    assert (check.jitters(32, state) == want).all()
    assert (check.jitters(1, state) == 0).all()


def test_verdict_needs_every_number_and_one_request():
    limits = {"frame_mean_d": 1.0, "frame_over8": 0.1, "hit_mismatch": 0.1,
              "lit_share_d": 0.01, "change_missed": 0.2}
    ok = {"frame_mean_d": 1.0, "frame_over8": 0.0, "hit_mismatch": 0.0,
          "lit_share_d": 0.0, "change_missed": 0.2, "n": 1}
    assert check.verdict(ok, limits)
    assert not check.verdict(dict(ok, n=0), limits)
    assert not check.verdict(dict(ok, hit_mismatch=0.11), limits)
