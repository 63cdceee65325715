"""The one traffic generator: a mix's parameters and a seed in, requests out.

A mix (``portbench/traffic/<name>.json``) is data. It names the ``user``
whose calls it makes (``view``: calls on the scene, each followed by the
view's shadow scan, burst and uint8 frame; ``session``: calls on the
session, each followed by ``Session.frame``; see program.py) and a
``deck`` of segments. A deck entry is a list of ``events``, each
``{"call": <public method of the user's object>, "args": [...]}``, played
``times`` times in a row; a list of counts in ``times`` makes one segment
per count, and ``copies`` repeats the entry's segments. Every round the
generator shuffles all segments with the seed and plays them in turn, so
every seed does the same work in another order. A segment draws each of
its random arguments once, when it starts:

* ``{"date": [from, to], "step_minutes": m}``: a datetime uniform on an
  m-minute grid in [from, to);
* ``{"polar": r, "axis": "x" | "y"}``: one component of a vector of
  length r in a direction drawn uniformly (a segment's axes share it);
* ``{"uniform": [lo, hi]}``: a float uniform in [lo, hi);
* ``{"choice": [a, b, ...]}``: one of the values.

A warm-up event may also give ``{"at": "start"}``: the configuration's
start date. A request is ``{"call": name, "args": [values]}``; the check
follows each call by name (program.view_states). Both users are closed
loops of one user: the next request goes out when the previous one has
returned.
"""

from __future__ import annotations

import math
from datetime import datetime, timedelta
from typing import Iterator

import numpy as np

USERS = ("view", "session")


def rng(seed: int, stream: int = 0) -> np.random.Generator:
    """A generator for ``seed`` (any whole number) and a stream index, so
    the traffic and the choice of checked requests draw apart."""
    return np.random.default_rng([int(seed) % 2**64, stream])


def parse_dt(text: str) -> datetime:
    dt = datetime.fromisoformat(text)
    if dt.tzinfo is None:
        raise ValueError(f"datetime {text!r} has no time zone")
    return dt


def segments(mix: dict) -> list[tuple[list, int]]:
    """The deck as (events, times) segments, in the mix's order."""
    out = []
    for entry in mix["deck"]:
        times = entry.get("times", 1)
        for n in (times if isinstance(times, list) else [times]):
            out += [(entry["events"], int(n))] * int(entry.get("copies", 1))
    return out


def _draw(arg, g: np.random.Generator, seg: dict):
    if not isinstance(arg, dict):
        return arg
    if "date" in arg:
        t0, t1 = (parse_dt(t) for t in arg["date"])
        step = int(arg.get("step_minutes", 1))
        n = int((t1 - t0).total_seconds() // 60) // step
        return t0 + timedelta(minutes=int(g.integers(0, n)) * step)
    if "polar" in arg:
        if "angle" not in seg:
            seg["angle"] = float(g.random()) * 2.0 * math.pi
        trig = math.cos if arg["axis"] == "x" else math.sin
        return float(arg["polar"]) * trig(seg["angle"])
    if "uniform" in arg:
        lo, hi = arg["uniform"]
        return float(lo + (hi - lo) * g.random())
    if "choice" in arg:
        return arg["choice"][int(g.integers(0, len(arg["choice"])))]
    raise ValueError(f"unknown argument {arg!r}")


def requests(mix: dict, seed: int) -> Iterator[dict]:
    if mix["user"] not in USERS:
        raise ValueError(f"unknown user {mix['user']!r}")
    g = rng(seed)
    deck = segments(mix)
    while True:
        for i in g.permutation(len(deck)):
            events, times = deck[int(i)]
            seg: dict = {}
            drawn = [{"call": e["call"],
                      "args": [_draw(a, g, seg) for a in e.get("args", [])]}
                     for e in events]
            for _ in range(times):
                for e in drawn:
                    yield {"call": e["call"], "args": list(e["args"])}


def warmup(mix: dict, start: datetime) -> list[dict]:
    """The mix's warm-up requests (untimed, before the window)."""
    out = []
    for e in mix.get("warmup", []):
        args = [start if a == {"at": "start"} else a
                for a in e.get("args", [])]
        if any(isinstance(a, dict) for a in args):
            raise ValueError(f"a warm-up event draws nothing: {e!r}")
        out.append({"call": e["call"], "args": args})
    return out


def checked_indices(mix: dict, seed: int) -> list[int]:
    """The window requests whose answers are compared with the reference:
    ``check.requests`` distinct indices drawn from the seed among the
    first ``check.span``, sorted."""
    c = mix["check"]
    g = rng(seed, 1)
    idx = g.choice(int(c["span"]), size=int(c["requests"]), replace=False)
    return sorted(int(i) for i in idx)
