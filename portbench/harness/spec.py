"""Finding a cell's parts by name.

``BENCHMARK.json`` at the root of the checkout names each cell's
configuration and traffic mix; a configuration's file is the one its
entry names, a mix is ``portbench/traffic/<mix>.json`` and a per-layer
metric's reader is ``portbench/metrics/<metric>.py`` (its function
``read(ctx)``). A later cell, mix or metric is new files and entries,
never an edit of these.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import Callable, Optional

ROOT = Path(__file__).resolve().parents[2]
PACKAGE = "portbench"


def load_benchmark(root: Path = ROOT) -> dict:
    with open(Path(root) / "BENCHMARK.json", encoding="utf-8") as f:
        return json.load(f)


def workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json (have: "
                   + ", ".join(w["name"] for w in bench["workloads"]) + ")")


def config(bench: dict, name: str, root: Path = ROOT) -> dict:
    """The configuration's file, as JSON, with its entry's name."""
    for c in bench["configs"]:
        if c["name"] == name:
            with open(Path(root) / c["file"], encoding="utf-8") as f:
                cfg = json.load(f)
            cfg["name"] = name
            return cfg
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def mix(name: str, root: Path = ROOT) -> dict:
    """The traffic mix ``portbench/traffic/<name>.json``."""
    with open(Path(root) / PACKAGE / "traffic" / f"{name}.json",
              encoding="utf-8") as f:
        out = json.load(f)
    out["name"] = name
    return out


def reader(metric: str, root: Path = ROOT) -> Callable:
    """``read`` of ``portbench/metrics/<metric>.py``, loaded by path (metric
    names carry dots, so they are not module names)."""
    path = Path(root) / PACKAGE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + metric.replace(".", "_").replace("-", "_"),
        path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _applies(metric: dict, cell: str, reported: Optional[set]) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return reported is None or metric.get("moves") in reported


def metrics_of(bench: dict, cell: str) -> tuple[list, list]:
    """(end-to-end metrics, per-layer metrics) that ``cell`` reports: those
    that list it, and those without a list (a per-layer one where the cell
    reports the end-to-end metric it moves)."""
    e2e = [m for m in bench["end_to_end"] if _applies(m, cell, None)]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"] if _applies(m, cell, names)]
    return e2e, layer
