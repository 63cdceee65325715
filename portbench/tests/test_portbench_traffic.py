"""The one traffic generator: reproducible from the seed, inside its mix."""

import itertools
from datetime import timedelta

import pytest

from harness import spec, traffic

BIG = 2**31 + 12345


def take(mix, seed, n):
    return list(itertools.islice(traffic.requests(mix, seed), n))


@pytest.mark.parametrize("name", ["jump", "held"])
def test_same_seed_same_requests(name):
    mix = spec.mix(name)
    assert take(mix, BIG, 300) == take(mix, BIG, 300)
    assert take(mix, BIG, 300) != take(mix, BIG + 1, 300)


def test_jump_dates_on_the_grid_and_in_range():
    mix = spec.mix("jump")
    lo, hi = (traffic.parse_dt(t)
              for t in mix["deck"][0]["events"][0]["args"][0]["date"])
    reqs = take(mix, 7, 2000)
    assert all(r["call"] == "update_view" for r in reqs)
    dts = [r["args"][0] for r in reqs]
    assert all(lo <= dt < hi for dt in dts)
    assert all((dt - lo) % timedelta(minutes=1) == timedelta(0)
               for dt in dts)
    years = {dt.year for dt in dts}
    assert min(years) < 1960 and max(years) > 2040   # spread over the span


def deal(reqs):
    """The stream cut back into segments: [what, length]."""
    segs = []
    for r in reqs:
        what = (r["call"], tuple(r["args"]))
        if segs and segs[-1][0] == what:
            segs[-1][1] += 1
        else:
            segs.append([what, 1])
    return segs


def test_session_deck_is_the_same_work_in_another_order():
    mix = spec.mix("held")
    per_deck = sum(len(ev) * n for ev, n in traffic.segments(mix))
    assert per_deck == 2 * (4 + 12 + 20 + 28) + 3 * 8 + (4 + 10 + 16)
    a, b = take(mix, 11, per_deck), take(mix, 12, per_deck)
    assert a != b

    def work(reqs):
        keys = sorted(r["args"][0] for r in reqs
                      if r["call"] == "handle_key")
        return keys, sum(r["call"] == "orbit_drag" for r in reqs)

    assert work(a) == work(b)
    assert "wwwqwqqw" in "".join(r["args"][0] if r["call"] == "handle_key"
                                 else "." for r in a)
    drags = [r for r in a if r["call"] == "orbit_drag"]
    assert len(drags) == 4 + 10 + 16
    assert all(abs((dx ** 2 + dy ** 2) ** 0.5 - 2) < 1e-9
               for dx, dy in (r["args"] for r in drags))
    bursts = sorted(n for what, n in deal(drags))
    assert bursts == [4, 10, 16]          # one direction a burst


def test_arguments_drawn_once_a_segment():
    mix = {"user": "view", "samples": 1, "deck": [
        {"times": [3], "events": [
            {"call": "pan_tilt", "args": [{"polar": 5, "axis": "x"},
                                          {"polar": 5, "axis": "y"}]},
            {"call": "set_brightness", "args": [{"choice": [60, 90]}]},
            {"call": "change_gamma", "args": [{"uniform": [-0.2, 0.2]}]}]}]}
    reqs = take(mix, 5, 9)
    assert [r["call"] for r in reqs[:3]] == ["pan_tilt", "set_brightness",
                                             "change_gamma"]
    assert reqs[0:3] == reqs[3:6] == reqs[6:9]
    dx, dy = reqs[0]["args"]
    assert abs(dx * dx + dy * dy - 25) < 1e-9
    assert reqs[1]["args"][0] in (60, 90)
    assert -0.2 <= reqs[2]["args"][0] < 0.2


def test_any_whole_seed():
    for seed in (0, -3, BIG, 2**40):
        assert len(take(spec.mix("held"), seed, 10)) == 10


@pytest.mark.parametrize("name", ["jump", "held"])
def test_checked_requests_from_the_seed(name):
    mix = spec.mix(name)
    a = traffic.checked_indices(mix, BIG)
    assert a == traffic.checked_indices(mix, BIG)
    assert len(set(a)) == mix["check"]["requests"] == len(a)
    assert all(0 <= i < mix["check"]["span"] for i in a)
    assert a != traffic.checked_indices(mix, BIG + 1)


def test_warmup_jump_starts_at_the_configuration_date():
    start = traffic.parse_dt("2024-04-15T21:00:00+00:00")
    assert traffic.warmup(spec.mix("jump"), start) == [
        {"call": "update_view", "args": [start]}]
    with pytest.raises(ValueError):
        traffic.warmup({"warmup": [{"call": "zoom",
                                    "args": [{"uniform": [0, 1]}]}]}, start)
