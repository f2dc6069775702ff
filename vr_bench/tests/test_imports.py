"""Nothing the benchmark loads is JAX or the JAX package: module names are
compared by their whole top-level name."""

import os
import subprocess
import sys
import textwrap

from vr_bench import run

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def test_top_level_names_are_compared_whole(monkeypatch):
    fake = {"volume_renderer_tpu_torch.ops.cuda_march": None, "torch": None}
    monkeypatch.setattr(sys, "modules", fake)
    assert run.forbidden_modules() == []
    monkeypatch.setattr(sys, "modules", {**fake, "jax.numpy": None, "volume_renderer_tpu": None})
    assert run.forbidden_modules() == ["jax", "volume_renderer_tpu"]


def test_a_run_loads_neither_jax_nor_the_jax_package():
    code = textwrap.dedent("""
        import json, sys
        from vr_bench import run
        res = run.run_cell(run.load_benchmark(), "vibez-lookup.fit", 7, 0.0, False, "cpu",
                           size=12)
        import vr_bench.trace, vr_bench.roofline
        for name in ("render_rays_per_s", "setup_s", "fwd_roofline_pct.orbit"):
            run.reader(name)
        print(json.dumps({"found": run.forbidden_modules(), "correct": res["correct"],
                          "port": "volume_renderer_tpu_torch" in sys.modules}))
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=600, env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    last = out.stdout.strip().splitlines()[-1]
    assert '"found": []' in last and '"port": true' in last, last


def test_without_the_program_the_run_fails_with_no_result(tmp_path):
    import shutil

    shutil.copytree(os.path.join(ROOT, "vr_bench"), tmp_path / "vr_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-m", "vr_bench.run", "--workload", "vibez-otf.orbit",
                          "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300, env=env)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
