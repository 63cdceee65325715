"""The run path on a tiny CPU scene, the command line's refusals, and
discovery of new cells, mixes and metrics by file name alone."""

import json
import os
import shutil
import subprocess
import sys
import time

import pytest

import tiny
from harness import cell, spec

SEED = 2**31 + 99


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make_root(tmp_path_factory.mktemp("checkout"))


def run(root, name, seed=SEED, seconds=3.0, traced=False, **kw):
    return cell.run_cell(name, seed, seconds, traced, time.perf_counter(),
                         root=root, device="cpu", **kw)


@pytest.mark.parametrize("name", ["march.jump", "blocked.held"])
def test_tiny_run_is_correct_and_reports_no_device_metric(root, name):
    r = run(root, name)
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["attempted"] >= 2
    assert r["checks"]["requests_compared"]["value"] == 2
    assert list(r["checks"]) == ["frame_mean_d", "frame_over8",
                                 "hit_mismatch", "lit_share_d",
                                 "change_missed", "requests_compared"]
    dev = r["device"]
    assert dev["platform"] == "cpu" and dev["memory_peak_bytes"] is None
    assert "busy_s" not in dev and "breakdown" not in r
    e2e, _ = spec.metrics_of(spec.load_benchmark(root), name)
    assert set(r["metrics"]) == {m["name"] for m in e2e}
    assert all(v["value"] > 0 for v in r["metrics"].values())


def test_traced_tiny_run_leaves_out_device_metrics(root):
    r = run(root, "blocked.held", traced=True)
    # host span only: the device metrics and the card's counters are
    # not reported without a card
    assert set(r["metrics"]) == {"session.event_ms.step"}
    assert "busy_s" not in r["device"]


def copy_bench(dest):
    shutil.copy(tiny.REPO / "BENCHMARK.json", dest / "BENCHMARK.json")
    shutil.copytree(tiny.BENCH_DIR, dest / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache",
                                                  "out"))


def test_refuses_without_the_program(tmp_path):
    copy_bench(tmp_path)
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                        "march.jump", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=tmp_path, capture_output=True,
                       text=True, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""
    assert "moonrtx_tpu_torch" in p.stderr


def test_refuses_without_a_card(tmp_path):
    copy_bench(tmp_path)
    os.symlink(tiny.REPO / "moonrtx_tpu_torch", tmp_path / "moonrtx_tpu_torch")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                        "march.jump", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=tmp_path, capture_output=True,
                       text=True, timeout=300, env=env)
    assert p.returncode != 0 and p.stdout.strip() == ""
    assert "no CUDA device" in p.stderr
    # the caches it set up are inside the checkout, at fixed paths
    assert (tmp_path / "portbench" / ".cache" / "maps").is_dir()


def test_new_configuration_mix_and_metric_are_files_alone(root, tmp_path):
    """A cell added as data: a new configuration file, a new mix file and a
    new metric's reader, found by the names BENCHMARK.json gives them."""
    new = tiny.make_root(tmp_path)
    bench = json.loads((new / "BENCHMARK.json").read_text())
    cfg = json.loads((new / "portbench/configs/tiny-moon1080-march.json")
                     .read_text())
    cfg["render"]["brightness"] = 120
    (new / "portbench/configs/bright.json").write_text(json.dumps(cfg))
    mix = json.loads((new / "portbench/traffic/jump-tiny.json").read_text())
    mix["deck"][0]["events"][0]["args"][0]["date"] = [
        "2030-01-01T00:00:00+00:00", "2030-02-01T00:00:00+00:00"]
    (new / "portbench/traffic/january.json").write_text(json.dumps(mix))
    (new / "portbench/metrics/views_done.py").write_text(
        "def read(ctx):\n    return float(ctx.completed)\n")
    bench["configs"].append(dict(bench["configs"][0], name="bright",
                                 file="portbench/configs/bright.json"))
    bench["workloads"].append({"name": "bright.january", "config": "bright",
                               "traffic": "january", "chips": 1,
                               "why": "a throwaway cell of the test"})
    bench["end_to_end"].append({"name": "views_done", "unit": "views",
                                "better": "higher", "bound": 0.25,
                                "source": "host_clock",
                                "workloads": ["bright.january"]})
    (new / "BENCHMARK.json").write_text(json.dumps(bench))
    r = run(new, "bright.january")
    assert r["correct"], r["checks"]
    assert r["metrics"]["views_done"]["value"] >= 2
    assert "view_ms" not in r["metrics"]          # march.jump's own
    assert spec.config(spec.load_benchmark(new), "bright", new)["render"][
        "brightness"] == 120


def test_every_metric_of_the_benchmark_has_a_reader():
    bench = spec.load_benchmark()
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(spec.reader(m["name"]))
    for w in bench["workloads"]:
        e2e, layer = spec.metrics_of(bench, w["name"])
        assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2
        assert layer
        spec.config(bench, w["config"])
        assert spec.mix(w["traffic"])["user"] in ("view", "session")


def test_a_new_kind_of_mix_is_a_data_file(root, tmp_path):
    """A mix of calls the two cells never make (zoom, pan, brightness and
    gamma through the session, then a re-accumulated frame) is a new file
    and a new cell alone, and the check follows it."""
    new = tiny.make_root(tmp_path)
    bench = json.loads((new / "BENCHMARK.json").read_text())
    mix = {"why": "a throwaway mix of the test", "user": "session",
           "samples": 2,
           "deck": [{"times": [2], "events": [
                        {"call": "pan_tilt",
                         "args": [{"polar": 6, "axis": "x"},
                                  {"polar": 6, "axis": "y"}]}]},
                    {"events": [{"call": "change_brightness",
                                 "args": [{"choice": [-20, 20]}]}]},
                    {"events": [{"call": "change_gamma",
                                 "args": [{"choice": [-0.3, 0.3]}]}]}],
           "warmup": [{"call": "zoom", "args": [240]},
                      {"call": "set_time", "args": [{"at": "start"}]}],
           "check": {"requests": 3, "span": 4}}
    (new / "portbench/traffic/settle.json").write_text(json.dumps(mix))
    bench["workloads"].append({"name": "march.settle",
                               "config": "tiny-moon1080-march",
                               "traffic": "settle", "chips": 1,
                               "why": "a throwaway cell of the test"})
    for m in bench["end_to_end"]:
        if m["name"] == "step_ms":
            m["workloads"].append("march.settle")
    (new / "BENCHMARK.json").write_text(json.dumps(bench))
    r = run(new, "march.settle")
    assert r["correct"], r["checks"]
    assert r["checks"]["requests_compared"]["value"] == 3
    assert r["metrics"]["step_ms"]["value"] > 0


def test_maps_that_are_not_the_configurations_end_the_run(root):
    from harness import program

    bench = spec.load_benchmark(root)
    cfg = spec.config(bench, "tiny-moon1080-march", root)
    good = program.fingerprint(program.read_maps(cfg))
    assert program.fingerprints_match(good, good)
    cfg["map_fingerprint"] = good
    program.load_maps(cfg)
    bad = dict(good, elevation=[v * (1 + 1e-5) for v in good["elevation"]])
    cfg["map_fingerprint"] = bad
    with pytest.raises(ValueError, match="not the configuration's"):
        program.load_maps(cfg)
    cfg["map_source"] = "loader"
    del cfg["map_fingerprint"]
    with pytest.raises(ValueError, match="no map_fingerprint"):
        program.load_maps(cfg)


def test_a_feature_moved_on_the_map_changes_the_fingerprint():
    import numpy as np

    from harness import program

    rng = np.random.default_rng(3)
    elev = rng.random((64, 128)).astype(np.float32)
    maps = dict(elevation=elev, radius_scale=1.0, albedo=elev[::2, ::2],
                starmap=None)
    moved = dict(maps, elevation=np.roll(elev, 1, axis=1))
    assert not program.fingerprints_match(program.fingerprint(maps),
                                          program.fingerprint(moved))
