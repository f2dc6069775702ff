"""The port's spans (``utils.profiling.span``): off and empty with no
profiler running; under ``utils.profiling.trace`` the facade's and the
training step's spans nest as the program calls them, each lies in the
Chrome trace as its ``vr.`` range within 0.1 ms once the benchmark's
readers have aligned the record, and the record is bounded."""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from volume_renderer_tpu_torch import (Camera, LightSource, RenderSettings, Scene, Volume,
                                       VolumeRenderer, henyey_greenstein_lut, train)
from volume_renderer_tpu_torch.ops.cuda_march import render_forward_fast
from volume_renderer_tpu_torch.utils import profiling
from vr_bench import program_spans
from vr_bench import trace as bench_trace

N = 10
W, H = 12, 10


def _emission():
    z, y, x = np.mgrid[0:N, 0:N, 0:N].astype(np.float32)
    c = (N - 1) / 2.0
    r = np.sqrt((x - c) ** 2 + (y - c) ** 2 + (z - c) ** 2) / c
    return np.exp(-4.0 * (r - 0.6) ** 2).astype(np.float32)


def _renderer():
    em = _emission()
    r = VolumeRenderer(device="cpu")
    r.volume_emission = Volume.create(em, device="cpu")
    r.volume_absorption = Volume.create(em * 0.8, device="cpu")
    r.volume_illumination = henyey_greenstein_lut(8, device="cpu")
    r.light_sources = [LightSource([5, 8, -4], [1, 0.7, 0.4])]
    r.focal_length, r.distance_to_object = 3.0, 6.0
    r.rotate(125, 25, 0)
    r.image_resolution = (W, H)
    return r


def _fit():
    em = _emission()
    scene = Scene(emission=Volume.create(em, device="cpu"),
                  absorption=Volume.create(em * 0.8, device="cpu"),
                  camera=Camera.create(focal_length=3.0, distance_to_object=6.0,
                                       device="cpu").rotate(125, 25, 0),
                  settings=RenderSettings.create(factor_absorption=0.6, device="cpu"))
    opts = scene.options(W, H)
    target = render_forward_fast(scene, opts)
    params, static = train.split_params(scene)
    with torch.no_grad():
        params["emission"].mul_(1.3).add_(0.05)
    opt = torch.optim.Adam(list(params.values()), lr=2e-3)
    return lambda: train.train_step_fast(params, opt, static, opts, target)


def test_no_profiler_no_record():
    profiling.clear()
    assert profiling.span("a") is profiling.span("b", device=True)   # the shared no-op
    with profiling.span("facade.render"):
        pass
    _renderer().render()
    _fit()()
    assert profiling.spans() == [] and profiling.RECORD.dropped == 0


def test_facade_render_spans_nest(tmp_path):
    r = _renderer()
    with profiling.trace(str(tmp_path)):
        r.render()
        r.render()
    spans = profiling.spans()
    roots = [i for i, s in enumerate(spans) if s.name == "facade.render"]
    assert len(roots) == 2 and all(spans[i].parent == -1 for i in roots)
    for root in roots:
        children = sorted(s.name for s in spans if s.parent == root)
        assert children == ["facade.build_scene", "facade.plan", "march.forward"]
    for s in spans:
        assert s.start_ns <= s.end_ns and s.device_ms is None
        if s.parent >= 0:
            p = spans[s.parent]
            assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns


def test_train_step_spans_nest(tmp_path):
    step = _fit()
    step()                                          # the optimizer's state, outside
    with profiling.trace(str(tmp_path)):
        loss = step()
    assert torch.isfinite(loss)
    spans = profiling.spans()
    assert [s.name for s in spans if s.parent == -1] == ["train.step"]
    assert sorted(s.name for s in spans if s.parent == 0) == ["march.forward", "train.optimizer"]
    opt = next(s for s in spans if s.name == "train.optimizer")
    assert opt.device_ms is None                    # a device span on the CPU: host times


def test_trace_clears_the_record(tmp_path):
    r = _renderer()
    with profiling.trace(str(tmp_path / "a")):
        r.render()
    assert profiling.spans()
    with profiling.trace(str(tmp_path / "b")):
        pass
    assert profiling.spans() == []


@pytest.mark.parametrize("outer", ["render", "step"])
def test_record_meets_the_chrome_ranges_after_alignment(tmp_path, outer):
    """The benchmark's enclosure alignment puts every record entry within
    0.1 ms of its own ``vr.`` range in the exported trace."""
    if outer == "render":
        r = _renderer()
        call = r.render
    else:
        call = _fit()
        call()
    with profiling.trace(str(tmp_path)) as prof:
        with bench_trace.span("window"):
            for _ in range(3):
                with bench_trace.span(outer):
                    call()
    with open(prof.trace_path) as f:
        events = json.load(f)["traceEvents"]
    tr = bench_trace.from_chrome(events)
    rec = profiling.spans()
    shift = program_spans.offset(tr, rec)
    assert shift is not None
    ranges = {}
    for ev in sorted((e for e in events if e.get("ph") == "X"
                      and str(e.get("name", "")).startswith("vr.")), key=lambda e: e["ts"]):
        s = 1e-6 * float(ev["ts"])
        ranges.setdefault(ev["name"][3:], []).append((s, s + 1e-6 * float(ev["dur"])))
    seen = {}
    assert rec
    for sp in rec:
        k = seen[sp.name] = seen.get(sp.name, -1) + 1
        s, e = ranges[sp.name][k]
        assert abs(1e-9 * sp.start_ns + shift - s) < 1e-4, sp
        assert abs(1e-9 * sp.end_ns + shift - e) < 1e-4, sp
    assert {k: len(v) for k, v in ranges.items()} == {k: v + 1 for k, v in seen.items()}


def test_the_record_is_bounded():
    limit = profiling.RECORD.limit
    profiling.clear()
    try:
        profiling.RECORD.limit = 3
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
            with profiling.span("outer"):
                for i in range(4):
                    with profiling.span(f"inner{i}"):
                        pass
            with profiling.span("after"):
                pass
        spans = profiling.spans()
        assert [s.name for s in spans] == ["outer", "inner0", "inner1"]
        assert [s.parent for s in spans] == [-1, 0, 0]
        assert profiling.RECORD.dropped == 3
    finally:
        profiling.RECORD.limit = limit
        profiling.clear()
    assert profiling.RECORD.dropped == 0


def test_device_span_on_the_cpu_records_host_times():
    profiling.clear()
    try:
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
            with profiling.span("train.optimizer", device=True):
                torch.ones(8).sum()
        (s,) = profiling.spans()
        assert s.name == "train.optimizer" and s.parent == -1
        assert 0 < s.start_ns <= s.end_ns and s.device_ms is None
    finally:
        profiling.clear()
