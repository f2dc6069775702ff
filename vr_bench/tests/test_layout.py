"""The harness finds every configuration, traffic mix, limit file and
metric reader by the names in BENCHMARK.json, and a new cell added as
files and entries alone."""

import json
import shutil

from vr_bench import checks, named, run


def test_every_named_piece_resolves():
    bench = run.load_benchmark()
    for wl in bench["workloads"]:
        spec = run.cell_spec(bench, wl["name"])
        loop = named.module("loops", spec["traffic"]["loop"])
        for fn in ("setup", "window", "route", "release", "check", "least", "readings"):
            assert callable(getattr(loop, fn))
        assert spec["config"]["name"] == wl["config"]
        assert checks.limits(wl["name"])
        for trace in (False, True):
            for m in run.metrics_for(bench, wl["name"], trace):
                assert callable(run.reader(m["name"]))
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert m["moves"] in {e["name"] for e in bench["end_to_end"]} if "moves" in m else True


def test_every_cell_reports_setup_another_end_to_end_and_a_per_layer_metric():
    bench = run.load_benchmark()
    for wl in bench["workloads"]:
        e2e = {m["name"] for m in run.metrics_for(bench, wl["name"], False)}
        assert "setup_s" in e2e and len(e2e) >= 2
        layer = run.metrics_for(bench, wl["name"], True)
        assert layer
        for m in layer:   # the metric it moves is reported in that cell
            assert m["moves"] in e2e


def test_a_cell_added_as_files_and_entries_alone(tmp_path):
    here = tmp_path / "vr_bench"
    shutil.copytree(run.HERE, here, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = run.load_benchmark()
    cfg = json.loads((here / "configs" / "vibez-otf.json").read_text())
    cfg["name"] = "vibez-otf-far"
    cfg["distance_to_object"] = 9.0
    (here / "configs" / "vibez-otf-far.json").write_text(json.dumps(cfg))
    traffic = json.loads((here / "traffic" / "orbit.json").read_text())
    traffic["rotate_deg"] = [0, 6, 0]
    (here / "traffic" / "slow-orbit.json").write_text(json.dumps(traffic))
    (here / "metrics" / "frames.orbit.py").write_text(
        "def read(run):\n    return float(run.window.frames)\n")
    # a loop, a data generator and a volume kind of its own, found by name
    (here / "loops" / "still.py").write_text("def window(ctx, seconds):\n    return seconds\n")
    (here / "data" / "flat.py").write_text("def make(spec, device, n=None):\n    return n\n")
    (here / "volumes" / "halved.py").write_text(
        "def make(spec, emission, device):\n    return emission / 2\n")
    assert named.module("loops", "still", here=str(here)).window(None, 3.0) == 3.0
    assert named.module("data", "flat", here=str(here)).make({}, "cpu", 5) == 5
    assert named.module("volumes", "halved", here=str(here)).make({}, 4.0, "cpu") == 2.0
    bench["configs"].append({"name": "vibez-otf-far", "source": "x",
                             "file": "vr_bench/configs/vibez-otf-far.json", "reduced": [],
                             "why": "x"})
    bench["workloads"].append({"name": "vibez-otf-far.slow-orbit", "config": "vibez-otf-far",
                               "traffic": "slow-orbit", "chips": 1, "why": "x"})
    bench["per_layer"].append({"name": "frames.orbit", "unit": "frames", "better": "higher",
                               "source": "program_counter", "layer": "facade and planner",
                               "moves": "render_rays_per_s",
                               "workloads": ["vibez-otf-far.slow-orbit"]})
    spec = run.cell_spec(bench, "vibez-otf-far.slow-orbit", root=str(tmp_path), here=str(here))
    assert spec["config"]["distance_to_object"] == 9.0
    assert spec["traffic"]["rotate_deg"] == [0, 6, 0]
    names = [m["name"] for m in run.metrics_for(bench, "vibez-otf-far.slow-orbit", True)]
    assert names == ["frames.orbit"]

    class W:
        frames = 7

    class R:
        window = W()

    assert run.reader("frames.orbit", here=str(here))(R()) == 7.0
