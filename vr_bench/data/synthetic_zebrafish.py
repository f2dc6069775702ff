"""The main channel of ``examples/_data.py:synthetic_zebrafish`` (the same
formula and random draws), made on the device: (D, H, W) = (n/2, 3n/4, n)
float32 in [0, 1]. ``spec``: ``n``, ``data_seed``."""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch


def make(spec: Dict, device, n: Optional[int] = None) -> torch.Tensor:
    return zebrafish(n or spec["n"], spec["data_seed"], device)


def zebrafish(n: int, data_seed: int, device, chunk: int = 32) -> torch.Tensor:
    """The volume at size ``n``, ``chunk`` z-slices at a time."""
    rng = np.random.default_rng(data_seed)
    d, h, w = n // 2, (3 * n) // 4, n
    zc, yc, xc = (d - 1) / 2, (h - 1) / 2, (w - 1) / 2
    lobes = []
    for _ in range(6):
        cx, cy, cz = rng.uniform(0.25, 0.75, 3) * (w, h, d)
        s = rng.uniform(0.06, 0.14) * n
        lobes.append((float(cx), float(cy), float(cz), float(s)))
    x = torch.arange(w, dtype=torch.float32, device=device)[None, None, :]
    y = torch.arange(h, dtype=torch.float32, device=device)[None, :, None]
    out = torch.empty((d, h, w), dtype=torch.float32, device=device)
    for z0 in range(0, d, chunk):
        z = torch.arange(z0, min(d, z0 + chunk), dtype=torch.float32, device=device)[:, None, None]
        r2 = (((x - xc) / (0.45 * w)) ** 2 + ((y - yc) / (0.4 * h)) ** 2
              + ((z - zc) / (0.4 * d)) ** 2)
        main = torch.exp(-2.5 * r2)
        for cx, cy, cz, s in lobes:
            main += 0.5 * torch.exp(-(((x - cx) ** 2 + (y - cy) ** 2 + (z - cz) ** 2)
                                      / (2 * s * s)))
        out[z0:z0 + z.shape[0]] = main
    return out.div_(out.max())
