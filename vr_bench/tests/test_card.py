"""One short run of each cell on the card, as the driver starts it."""

import json
import os
import subprocess
import sys

import pytest

from vr_bench import run

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


@pytest.mark.card
@pytest.mark.parametrize("workload", [w["name"] for w in run.load_benchmark()["workloads"]])
def test_a_short_run_on_the_card_is_correct(card, workload):
    out = subprocess.run([sys.executable, "-m", "vr_bench.run", "--workload", workload,
                          "--seed", str(2 ** 31 + 3), "--seconds", "2", "--trace", "0"],
                         cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"], res["checks"]
    assert res["device"]["platform"] == "gpu" and res["device"]["count"] == 1
