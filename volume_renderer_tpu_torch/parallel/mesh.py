"""Device lists (the port's counterpart of ``jax.sharding.Mesh``).

The port is one process that drives every device. A mesh is a plain list of
``torch.device``s, one per brick, and a device may appear more than once:
on one card all bricks live on ``cuda:0``, on a host with four cards the
same code puts bricks on each of them.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Union

import torch

DeviceLike = Union[str, torch.device]


def _canonical(device: DeviceLike) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def make_mesh(n: int, devices: Optional[Union[DeviceLike, Sequence[DeviceLike]]] = None
              ) -> List[torch.device]:
    """``n`` devices, brick b on the b-th: ``devices`` repeated round-robin.

    ``devices`` defaults to every CUDA card, ``cuda:0 .. cuda:k-1``; without
    a card that raises, and the caller asks for the CPU by name
    (``devices="cpu"``), as the tests do.
    """
    n = int(n)
    if n < 1:
        raise ValueError(f"a mesh needs at least one device, got n={n}")
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device available; pass devices='cpu' to run the plain "
                "PyTorch version on the CPU")
        pool = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    elif isinstance(devices, (str, torch.device)):
        pool = [_canonical(devices)]
    else:
        pool = [_canonical(d) for d in devices]
        if not pool:
            raise ValueError("devices must not be empty")
    return [pool[i % len(pool)] for i in range(n)]
