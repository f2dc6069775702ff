"""Reads on the card the numbers that set a cell's limits: the program's
own (``program``: a fit's check steps in set-up, no window), the control
(``control``: the reference computed in bfloat16, the precision below the
configurations' float32, in the program's place) and, for a fit, half of
the batch left out (``half_batch``: the loss over half of the rays,
doubled), each against the float64 reference, on several seeds at the
cell's own size, inputs made once. The cell's loop
(``loops/<loop>.py:readings``) takes them. The benchmark's runs do not run
it; its numbers set the limits in ``limits/``.

    python3 -m vr_bench.control --workload <name> --seeds <n> [<n> ...]
        [--faults program control half_batch] [--frames <n>]
        [--traffic <mix>] [--check-steps <n>]

``--traffic`` and ``--check-steps`` read the cell's configuration under
another traffic mix or number of check steps. One line of JSON a seed on
standard output.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time

import torch

from vr_bench import cell, inputs, named, run


def context(workload: str, seed: int, device, inp=None, traffic=None,
            check_steps=None) -> cell.Context:
    spec = run.cell_spec(run.load_benchmark(), workload)
    tr = spec["traffic"]
    if traffic:
        with open(os.path.join(run.HERE, "traffic", traffic + ".json")) as f:
            tr = json.load(f)
    if check_steps:
        tr = {**tr, "check": {**tr["check"], "steps": check_steps}}
    inp = inp or inputs.make_inputs(spec["config"], device)
    w, h = inputs.image_size(spec["config"], inp.emission)
    return cell.Context(workload=workload, cfg=spec["config"], traffic=tr, seed=seed,
                        device=device, inputs=inp, width=w, height=h)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--faults", nargs="+", default=["control", "half_batch"],
                    help="the readings to take: program, control, half_batch")
    ap.add_argument("--frames", type=int, default=250,
                    help="an orbit window's frames, whose poses the check samples")
    ap.add_argument("--traffic", help="another traffic mix for the cell's configuration")
    ap.add_argument("--check-steps", type=int, help="another number of a fit's check steps")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("vr_bench.control: no CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    inp = None
    for seed in args.seeds:
        t = time.perf_counter()
        ctx = context(args.workload, seed, dev, inp, args.traffic, args.check_steps)
        inp = ctx.inputs
        got = named.module("loops", ctx.traffic["loop"]).readings(ctx, args.faults, args.frames)
        print(json.dumps({"workload": args.workload, "seed": seed, "traffic": ctx.traffic,
                          **got, "seconds": time.perf_counter() - t}), flush=True)
        del ctx, got
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
