"""The readers of the program's spans (``program_spans.py`` and the metrics
that use it) on synthetic traces and records, on a port without spans, and
in CPU runs of an orbit cell and a fit cell."""

from types import SimpleNamespace

import pytest

from vr_bench import program, program_spans, run
from vr_bench.cell import Window
from vr_bench.trace import Trace

SHIFT = 1000.0      # the record's clock runs this many seconds ahead of the trace's


def _span(name, parent, start, end, device_ms=None):
    """A record entry at trace seconds ``start``-``end``."""
    return SimpleNamespace(name=name, parent=parent, start_ns=round((start + SHIFT) * 1e9),
                           end_ns=round((end + SHIFT) * 1e9), device_ms=device_ms)


def _port(monkeypatch, rec):
    prof = SimpleNamespace() if rec is None else SimpleNamespace(spans=lambda: list(rec))
    monkeypatch.setattr(program, "port", lambda: SimpleNamespace(utils=SimpleNamespace(
        profiling=prof)))


def _data(window, trace):
    return run.RunData(workload="x", setup_s=1.0, window=window, trace=trace)


def _orbit():
    """Two frames in a 10 s window; the card busy 1.5-2.8 (march), 2.95-3.0
    (readback), 5.5-6.0 and 6.2-6.8; a frame of an earlier profile in the
    record, outside the window."""
    ops = [("march_kernel", 1.5, 2.8), ("Memcpy DtoH", 2.95, 3.0), ("march_kernel", 5.5, 6.0),
           ("elementwise_kernel", 6.2, 6.8)]
    spans = [("window", 0.0, 10.0), ("render", 1.0, 3.0), ("readback", 3.0, 3.2),
             ("render", 5.0, 7.0)]
    rec = [_span("facade.render", -1, -50.0, -49.0)]
    for t0, pack in ((1.0, 12.0), (5.0, 14.0)):
        i = len(rec)
        rec += [_span("facade.render", -1, t0 + 0.1, t0 + 1.9),
                _span("facade.build_scene", i, t0 + 0.2, t0 + 0.3),
                _span("facade.plan", i, t0 + 0.3, t0 + 0.35),
                _span("march.forward", i, t0 + 0.4, t0 + 0.9),
                _span("march.pack", i + 3, t0 + 0.45, t0 + 0.6, device_ms=pack)]
    return Window(seconds=10.0, frames=2), Trace(window=(0.0, 10.0), device_ops=ops,
                                                 spans=spans), rec


def test_orbit_readers_on_a_synthetic_trace(monkeypatch):
    w, tr, rec = _orbit()
    _port(monkeypatch, rec)
    assert program_spans.offset(tr, program_spans.record()) == pytest.approx(-SHIFT)
    got = {m: run.reader(m)(_data(w, tr)) for m in (
        "scene_build_ms.orbit", "plan_ms.orbit", "forward_host_ms.orbit",
        "facade_idle_pct.orbit", "pack_ms.orbit", "device_idle_pct.orbit")}
    assert got["scene_build_ms.orbit"] == pytest.approx(100.0)
    assert got["plan_ms.orbit"] == pytest.approx(50.0)
    assert got["forward_host_ms.orbit"] == pytest.approx(500.0)
    assert got["pack_ms.orbit"] == pytest.approx(13.0)
    # idle inside facade.render: 1.1-1.5 and 2.8-2.9, then 5.1-5.5, 6.0-6.2, 6.8-6.9
    assert got["facade_idle_pct.orbit"] == pytest.approx(100.0 * 1.2 / 10.0)
    assert got["device_idle_pct.orbit"] == pytest.approx(100.0 * (10.0 - 2.45) / 10.0)
    assert got["facade_idle_pct.orbit"] <= got["device_idle_pct.orbit"]
    # a fit's readers find no step to read in an orbit
    assert run.reader("step_host_ms.fit")(_data(w, tr)) is None
    assert run.reader("optimizer_ms.fit")(_data(w, tr)) is None


def test_idle_gaps_outside_the_program_are_not_counted(monkeypatch):
    w, tr, rec = _orbit()
    # the card idle all through a long readback span outside facade.render
    tr.device_ops = [op for op in tr.device_ops if op[0] != "Memcpy DtoH"]
    _port(monkeypatch, rec)
    assert run.reader("facade_idle_pct.orbit")(_data(w, tr)) == pytest.approx(12.0)
    assert run.reader("device_idle_pct.orbit")(_data(w, tr)) == pytest.approx(76.0)


def test_fit_readers_on_a_synthetic_trace(monkeypatch):
    ops = [("march_kernel", 1.2, 3.9), ("march_kernel", 5.2, 7.9)]
    spans = [("window", 0.0, 10.0), ("step", 1.0, 4.0), ("step", 5.0, 8.0)]
    rec = []
    for t0, opt_ms, pack in ((1.0, 9.0, 15.0), (5.0, 11.0, 16.0)):
        i = len(rec)
        rec += [_span("train.step", -1, t0 + 0.01, t0 + 2.99),
                _span("march.pack", i, t0 + 0.02, t0 + 0.03, device_ms=pack),
                _span("march.forward", i, t0 + 0.03, t0 + 0.05),
                _span("march.backward", i, t0 + 0.05, t0 + 0.07),
                _span("train.optimizer", i, t0 + 0.07, t0 + 0.08, device_ms=opt_ms)]
    _port(monkeypatch, rec)
    w = Window(seconds=10.0, steps=2)
    tr = Trace(window=(0.0, 10.0), device_ops=ops, spans=spans)
    assert run.reader("step_host_ms.fit")(_data(w, tr)) == pytest.approx(2980.0)
    assert run.reader("optimizer_ms.fit")(_data(w, tr)) == pytest.approx(10.0)
    assert run.reader("pack_ms.fit")(_data(w, tr)) == pytest.approx(15.5)
    assert run.reader("facade_idle_pct.orbit")(_data(w, tr)) is None


def test_host_only_device_spans_give_nothing(monkeypatch):
    w, tr, rec = _orbit()
    rec = [sp if sp.name != "march.pack" else SimpleNamespace(**{**vars(sp), "device_ms": None})
           for sp in rec]
    _port(monkeypatch, rec)
    assert run.reader("pack_ms.orbit")(_data(w, tr)) is None
    assert run.reader("plan_ms.orbit")(_data(w, tr)) == pytest.approx(50.0)


@pytest.mark.parametrize("rec", [None, []])
def test_a_port_without_spans_gives_nothing(monkeypatch, rec):
    w, tr, _ = _orbit()
    _port(monkeypatch, rec)
    for m in ("scene_build_ms.orbit", "plan_ms.orbit", "forward_host_ms.orbit",
              "facade_idle_pct.orbit", "pack_ms.orbit", "pack_ms.fit", "step_host_ms.fit",
              "optimizer_ms.fit"):
        assert run.reader(m)(_data(w, tr)) is None, m
    assert run.reader("facade_host_ms.orbit")(_data(w, tr)) is None   # no host_s either


@pytest.mark.parametrize("workload,host", [
    ("vibez-otf.orbit", ("scene_build_ms.orbit", "plan_ms.orbit", "forward_host_ms.orbit")),
    ("vibez-lookup.fit", ("step_host_ms.fit",))])
def test_cpu_runs_read_the_host_spans(workload, host):
    res = run.run_cell(run.load_benchmark(), workload, 5000000011, seconds=0.5, trace=True,
                       device="cpu", size=12)
    got = {k: v["value"] for k, v in res["metrics"].items()}
    for m in host:
        assert isinstance(got.get(m), float) and got[m] > 0.0, (m, got)
    # the card's numbers are not read on the CPU
    for m in ("facade_idle_pct.orbit", "pack_ms.fit", "optimizer_ms.fit"):
        assert m not in got
    if "facade_host_ms.orbit" in got:
        assert sum(got[m] for m in host) <= got["facade_host_ms.orbit"]
