"""A checkout-shaped directory with the benchmark's two cells cut to a
size a CPU test can run: 192x144 frames on a 360x720 synthetic map
(shadow accuracy 4), the real mixes' parameters with a shorter checked
span, 2-sample views and, for the session, half-day steps, so one step
moves the terminator by pixels at this size. The check limits here are
the tiny scene's own, set from its readings on the CPU (seeds 1, 2, 3,
31337, 2**31 + 99 and 77): the program at most 0.47 / 0.0095 / 1.45e-4 /
2.7e-3 / 0.013 (frame_mean_d, frame_over8, hit_mismatch, lit_share_d,
change_missed; march.jump) and 0.060 / 0.0012 / 3.6e-5 / 1.8e-4 / 0.0021
(blocked.held); the bfloat16 control at least 36 / 0.41 / 0.48 / 0.29 /
1.30 and a stale frame at least 1.0 on change_missed (seeds 1, 2, 3)."""

import json
import shutil
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
REPO = BENCH_DIR.parent
LIMITS = {"frame_mean_d": 1.5, "frame_over8": 0.02, "hit_mismatch": 0.005,
          "lit_share_d": 0.005, "change_missed": 0.1}


def make_root(dest: Path) -> Path:
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    pb = dest / "portbench"
    shutil.copytree(BENCH_DIR / "metrics", pb / "metrics",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (pb / "configs").mkdir(parents=True)
    (pb / "traffic").mkdir()
    cells = {}
    for w in bench["workloads"]:
        entry = next(c for c in bench["configs"] if c["name"] == w["config"])
        cfg = json.loads((REPO / entry["file"]).read_text())
        cfg.update(map_source="synth", map_rows=360, map_cols=720,
                   map_seed=5, map_craters=150, check=dict(LIMITS))
        cfg.pop("map_fingerprint", None)
        cfg["render"].update(width=192, height=144, shadow_accuracy=4)
        name = "tiny-" + w["config"]
        (pb / "configs" / f"{name}.json").write_text(json.dumps(cfg))
        mix = json.loads((BENCH_DIR / "traffic" / f"{w['traffic']}.json")
                         .read_text())
        if mix["user"] == "view":
            mix["samples"] = 2
        else:
            mix["step_minutes"] = 720
        mix["check"] = {"requests": 2, "span": 2}
        mname = w["traffic"] + "-tiny"
        (pb / "traffic" / f"{mname}.json").write_text(json.dumps(mix))
        cells[w["name"]] = (dict(entry, name=name,
                                 file=f"portbench/configs/{name}.json"),
                            dict(w, config=name, traffic=mname))
    bench["configs"] = [c for c, _ in cells.values()]
    bench["workloads"] = [w for _, w in cells.values()]
    (dest / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return dest
