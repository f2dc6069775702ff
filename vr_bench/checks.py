"""The numbers that decide ``correct``: what the timed path produced,
against the plain reference (``reference/lit_march.py``) run on the same
inputs once the window has closed.

- A frame: the widest gap of a sampled pixel's channel from the
  reference's, over the frame's largest reference value among the sampled
  pixels (``pixel_gap``), the worst frame.
- A fit: each of the first steps' loss against the reference's
  (``loss_gap``, relative, the worst step); the norm of each leaf's first
  gradient as the optimizer got it (Adam's first moment after one step
  over 1 - beta1) against the reference's (``grad_norm_gap``, the median
  leaf); the norm of each leaf's change over those steps against the
  reference's (``change_norm_gap``, the worst leaf). A norm's gap is
  |program - reference| over the larger of the reference's norm of that
  leaf and of the median leaf. A leaf whose reference gradient is under a
  thousandth of the median leaf's moves by round-off alone and is left
  out of the change. A number that is NaN fails.
"""

from __future__ import annotations

import json
import math
import os
import statistics
from typing import Dict, List, Sequence

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
ROUND_OFF_SHARE = 1e-3


def _limit_file(workload: str) -> Dict:
    with open(os.path.join(HERE, "limits", workload + ".json")) as f:
        return json.load(f)


def limits(workload: str) -> Dict[str, float]:
    """The cell's limits, from ``limits/<workload>.json``."""
    return {k: float(v) for k, v in _limit_file(workload)["limits"].items()}


def grid_leaves(workload: str) -> List[str]:
    """The grid leaves whose first gradient the cell holds on its own."""
    return list(_limit_file(workload).get("grid_grad_leaves", []))


def pixel_gap(program: Sequence[torch.Tensor], reference: Sequence[torch.Tensor]) -> float:
    """The worst frame's widest channel gap over its largest reference value;
    each pair is (P, 3) of one frame's sampled pixels."""
    worst = 0.0
    for p, r in zip(program, reference):
        r = r.to(torch.float64)
        scale = float(r.abs().max())
        gap = float((p.to(torch.float64) - r).abs().max())
        worst = max(worst, gap / scale if scale > 0 else gap)
    return worst


def _worst(values: Sequence[float]) -> float:
    """The largest, or NaN where any is NaN (a number that is not there
    fails)."""
    values = list(values)
    return math.nan if any(math.isnan(v) for v in values) else max(values, default=0.0)


def leaf_gaps(program: Dict[str, float], reference: Dict[str, float],
              keys: Sequence[str]) -> Dict[str, float]:
    """Each leaf's gap of norms over the larger of its reference norm and
    the median leaf's."""
    median = statistics.median(reference[k] for k in keys)
    return {k: abs(program[k] - reference[k]) / max(reference[k], median) for k in keys}


def fit_numbers(program: Dict, reference: Dict, grid: Sequence[str] = ()) -> Dict[str, float]:
    """``program`` and ``reference``: {"losses": [...], "grad_norms": {leaf:
    norm}, "change_norms": {leaf: norm}}; ``grid``: the grid leaves held on
    their own. The first gradient is also compared by its median leaf: on
    the OTF fit the emission leaf's norm is set by samples whose shading
    angles are ill-defined, and moves by up to 27 % between float32 and
    float64 (PERF.md §2)."""
    ref_g = reference["grad_norms"]
    median = statistics.median(ref_g.values())
    moved = [k for k, v in ref_g.items() if v >= ROUND_OFF_SHARE * median]
    grads = leaf_gaps(program["grad_norms"], ref_g, list(ref_g))
    out = {
        "loss_gap": _worst(abs(p - r) / abs(r)
                           for p, r in zip(program["losses"], reference["losses"])),
        "grad_norm_gap": (math.nan if any(math.isnan(v) for v in grads.values())
                          else statistics.median(grads.values())),
        "change_norm_gap": _worst(leaf_gaps(program["change_norms"],
                                            reference["change_norms"], moved).values()),
    }
    if grid:
        out["grid_grad_gap"] = _worst(
            abs(program["grad_norms"][k] - ref_g[k]) / ref_g[k] if ref_g[k] > 0
            else (0.0 if program["grad_norms"][k] == 0 else math.inf) for k in grid)
    return out


def verdict(numbers: Dict[str, float], lim: Dict[str, float]) -> List[Dict]:
    """One entry a number: its name, value, limit and whether it is within."""
    return [{"name": k, "value": v, "limit": lim[k], "ok": bool(v <= lim[k])}
            for k, v in numbers.items()]
