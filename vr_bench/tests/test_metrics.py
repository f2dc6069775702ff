"""The metric arithmetic on synthetic windows and traces."""

import statistics

import pytest

from vr_bench import run
from vr_bench.cell import Window
from vr_bench.trace import Trace, from_chrome


def _data(window, trace=None):
    return run.RunData(workload="x", setup_s=12.5, window=window, trace=trace)


def test_rate_is_over_the_whole_window():
    # three frames of a 1000-ray image in a window of 2 s: the idle time
    # between frames counts
    w = Window(seconds=2.0, frames=3, frame_s=[0.1, 0.1, 0.1], host_s=[0.01] * 3, rays=3000)
    assert run.reader("render_rays_per_s")(_data(w)) == pytest.approx(1500.0)
    assert run.reader("setup_s")(_data(w)) == 12.5


def test_p95_is_over_every_frame():
    frames = [0.1] * 190 + [0.2] * 10
    w = Window(seconds=21.0, frames=200, frame_s=frames, rays=200)
    got = run.reader("frame_ms_p95")(_data(w))
    assert got == pytest.approx(1e3 * statistics.quantiles(frames, n=100,
                                                          method="inclusive")[94])
    assert 100.0 < got <= 200.0
    # not a median of chunks: one slow frame in twenty moves it
    assert run.reader("frame_ms_p95")(_data(Window(seconds=2, frames=20,
                                                   frame_s=[0.1] * 19 + [1.0]))) > 100.0


def test_step_ms_and_host_span():
    w = Window(seconds=3.0, steps=12)
    assert run.reader("step_ms")(_data(w)) == pytest.approx(250.0)
    w = Window(seconds=1.0, frames=2, frame_s=[0.1, 0.1], host_s=[0.002, 0.004])
    assert run.reader("facade_host_ms.orbit")(_data(w)) == pytest.approx(3.0)


def _trace():
    # window 0-10 s; device busy 1-3 (k1), 2-4 (k2, overlapping), 6-7 (memcpy)
    ops = [("void march_kernel<true>(MarchArgs)", 1.0, 3.0), ("adam", 2.0, 4.0),
           ("Memcpy DtoH", 6.0, 7.0), ("outside", 11.0, 12.0)]
    spans = [("window", 0.0, 10.0), ("render", 0.5, 4.5), ("readback", 4.5, 8.0)]
    return Trace(window=(0.0, 10.0), device_ops=ops, spans=spans)


def test_idle_share_and_gaps():
    tr = _trace()
    assert tr.busy_s() == pytest.approx(4.0)
    w = Window(seconds=10.0, frames=1, steps=2)
    assert run.reader("device_idle_pct.orbit")(_data(w, tr)) == pytest.approx(60.0)
    gaps = dict((round(t, 6), n) for n, t in tr.gaps())
    assert gaps == {1.0: "render", 2.0: "readback", 3.0: "none"}
    bd = tr.breakdown()
    assert bd["device_ops"][0][1] == pytest.approx(2.0)
    assert [g[0] for g in bd["idle_gaps"]] == ["none", "readback", "render"]
    assert tr.label_at(9.5) == "none"
    # glue: all device time but the march kernels, a step
    assert run.reader("step_glue_ms.fit")(_data(w, tr)) == pytest.approx(1e3 * 3.0 / 2)


def test_from_chrome_reads_device_events_and_spans():
    ev = [{"ph": "X", "cat": "kernel", "name": "k", "ts": 1e6, "dur": 5e5},
          {"ph": "X", "cat": "user_annotation", "name": "vr_bench.window", "ts": 0, "dur": 2e6},
          {"ph": "X", "cat": "cpu_op", "name": "aten::add", "ts": 0, "dur": 1e6}]
    tr = from_chrome(ev)
    assert tr.window == (0.0, 2.0)
    assert tr.busy_s() == pytest.approx(0.5)
    assert tr.kernel_seconds("k") == pytest.approx(0.5)


def test_one_reader_serves_every_suffix_of_its_stem():
    w = Window(seconds=1.0, frames=2, frame_s=[0.1, 0.1], host_s=[0.002, 0.004])
    for name in ("facade_host_ms.orbit", "facade_host_ms.stereo", "facade_host_ms"):
        assert run.reader(name)(_data(w)) == pytest.approx(3.0)
