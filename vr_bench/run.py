"""Runs one cell of the benchmark of ``volume_renderer_tpu_torch``.

    python3 -m vr_bench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Everything comes from ``BENCHMARK.json`` by
name: the cell's configuration (``configs/<config>.json``, whose data
generator and volume kinds are modules under ``data/`` and ``volumes/``),
its traffic mix (``traffic/<traffic>.json``, run by the generator
``loops/<loop>.py`` that its ``loop`` key names), the limits of its check
(``limits/<cell>.json``) and one reader per metric (``metrics/<metric>.py``,
or ``metrics/<stem>.py`` for a name ``<stem>.<suffix>`` that has no file
of its own). With ``--trace 0`` the
line carries the cell's end-to-end metrics, with ``--trace 1`` its
per-layer metrics, read from a profile of the window.

The last line of standard output is one JSON object; the numbers compared
with the reference are the last lines of standard error and the last key
of that object. Without a CUDA card, with fewer cards than the cell asks
for, or without the program beside it, the run fails and prints no result.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from dataclasses import dataclass  # noqa: E402
from typing import Dict, List, Optional  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "volume_renderer_tpu")


@dataclass
class RunData:
    """What a metric reader reads."""

    workload: str
    setup_s: float
    window: object          # cell.Window
    trace: object = None    # trace.Trace, traced runs only
    least: Optional[Dict] = None


def load_benchmark(root: str = ROOT) -> Dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def cell_spec(bench: Dict, workload: str, root: str = ROOT, here: str = HERE) -> Dict:
    """The cell's workload entry, configuration and traffic mix, by name
    (``here``: the benchmark's folder)."""
    wl = next((w for w in bench["workloads"] if w["name"] == workload), None)
    if wl is None:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == wl["config"])
    with open(os.path.join(root, conf["file"])) as f:
        cfg = json.load(f)
    with open(os.path.join(here, "traffic", wl["traffic"] + ".json")) as f:
        traffic = json.load(f)
    return {"workload": wl, "config": cfg, "traffic": traffic}


def metrics_for(bench: Dict, workload: str, trace: bool) -> List[Dict]:
    kind = "per_layer" if trace else "end_to_end"
    return [m for m in bench[kind] if workload in m.get("workloads", [workload])]


def reader(name: str, here: str = HERE):
    """``metrics/<name>.py``'s ``read``, else that of ``metrics/<stem>.py``
    for a name ``<stem>.<suffix>``: one reader serves a quantity that is
    split by the end-to-end metric it moves."""
    path = os.path.join(here, "metrics", name + ".py")
    if not os.path.exists(path):
        path = os.path.join(here, "metrics", name.split(".")[0] + ".py")
    spec = importlib.util.spec_from_file_location("vr_bench.metrics." + name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is one the run must not load,
    compared whole (``volume_renderer_tpu_torch`` is not
    ``volume_renderer_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def power_limit_w() -> Optional[float]:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits"], capture_output=True,
                             text=True, timeout=30, check=True).stdout
        return float(out.splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def run_cell(bench: Dict, workload: str, seed: int, seconds: float, trace: bool, device,
             t0: float = T0, size: Optional[int] = None) -> Dict:
    """One run of ``workload``; returns the result object. ``size``
    overrides the data's ``n`` (the CPU tests' small scenes)."""
    import torch

    from vr_bench import cell, checks, inputs, named
    from vr_bench.trace import profiled

    spec = cell_spec(bench, workload)
    cfg, traffic = spec["config"], spec["traffic"]
    device = torch.device(device)
    inp = inputs.make_inputs(cfg, device, n=size)
    width, height = inputs.image_size(cfg, inp.emission)
    ctx = cell.Context(workload=workload, cfg=cfg, traffic=traffic, seed=seed, device=device,
                       inputs=inp, width=width, height=height)
    loop = named.module("loops", traffic["loop"])
    loop.setup(ctx)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - t0

    held: Dict = {}
    with profiled(trace, held):
        window = loop.window(ctx, seconds)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    faults = loop.route(ctx, window) if device.type == "cuda" else []
    if faults:
        raise RuntimeError("the cell took another route: " + "; ".join(faults))
    loop.release(ctx)
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    t_check = time.perf_counter()
    numbers = loop.check(ctx, window)
    verdict = checks.verdict(numbers, checks.limits(workload))
    t_least = time.perf_counter()
    data = RunData(workload=workload, setup_s=setup_s, window=window,
                   trace=held.get("trace"), least=loop.least(ctx, window) if trace else None)
    print(f"vr_bench: {workload} seed {seed}: set-up {setup_s:.3f} s, window "
          f"{window.seconds:.3f} s ({window.frames or window.steps} "
          f"{'frames' if window.frames else 'steps'}), check {t_least - t_check:.3f} s, "
          f"roofline count {time.perf_counter() - t_least:.3f} s", file=sys.stderr)
    metrics = {}
    for m in metrics_for(bench, workload, trace):
        value = reader(m["name"])(data)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": 1, "memory_peak_bytes": int(peak)}
    if device.type == "cuda":
        dev["power_limit_w"] = power_limit_w()
    result = {"correct": all(v["ok"] for v in verdict),
              "attempted": window.frames or window.steps, "failed": 0,
              "metrics": metrics, "device": dev}
    if trace:
        tr = data.trace
        dev["busy_s"] = tr.busy_s()
        dev["window_s"] = tr.window_s
        result["breakdown"] = tr.breakdown()
        result["roofline_bounds"] = {k: v["bound"] for k, v in data.least.items()
                                     if isinstance(v, dict)}
    result["checks"] = {v["name"]: {"value": v["value"], "limit": v["limit"]} for v in verdict}
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # every build and kernel cache of the run at a fixed place in the checkout
    # (the port builds its kernels into build/kernels/ there itself)
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(ROOT, "build", "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "build", "triton")

    import torch

    bench = load_benchmark()
    spec = cell_spec(bench, args.workload)
    chips = spec["workload"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"vr_bench: the cell needs {chips} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} found",
              file=sys.stderr)
        return 2
    try:
        from vr_bench import program

        program.port()
    except ImportError as e:
        print(f"vr_bench: the program is not importable: {e}", file=sys.stderr)
        return 3
    result = run_cell(bench, args.workload, args.seed, args.seconds, bool(args.trace),
                      torch.device("cuda", 0))
    found = forbidden_modules()
    if found:
        print(f"vr_bench: the run loaded {', '.join(found)}", file=sys.stderr)
        return 4
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
