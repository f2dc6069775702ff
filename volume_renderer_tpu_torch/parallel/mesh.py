"""Device lists (the port's counterpart of ``jax.sharding.Mesh``).

The port is one process that drives every device. A mesh is a plain list of
``torch.device``s, one per brick or per band of image rows, and a device
may appear more than once: on one card every brick and band lives on
``cuda:0``, on a host with four cards the same code spreads them. A rows x
bricks mesh (``make_mesh_2d``) is a list of such lists, ``mesh[r][b]``.
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


def make_mesh_2d(n_bands: int, n_bricks: int,
                 devices: Optional[Union[DeviceLike, Sequence[DeviceLike]]] = None
                 ) -> List[List[torch.device]]:
    """A rows x bricks mesh: ``n_bands`` lists of ``n_bricks`` devices,
    ``mesh[r][b]`` the device of brick b of band r (the JAX package's
    ``Mesh(devices.reshape(n_bands, n_bricks), ("rays", "bricks"))``),
    ``devices`` repeated round-robin in that order, as ``make_mesh`` does."""
    flat = make_mesh(int(n_bands) * int(n_bricks), devices)
    return [flat[r * n_bricks:(r + 1) * n_bricks] for r in range(int(n_bands))]


def check_mesh(mesh, what: str) -> List[torch.device]:
    """``mesh`` as a list of devices, one per ``what`` (brick or band);
    raises ``ValueError`` for anything else."""
    if (not isinstance(mesh, (list, tuple)) or len(mesh) < 1
            or any(isinstance(d, (list, tuple)) for d in mesh)):
        raise ValueError(f"mesh must be a list of devices, one per {what} "
                         "(parallel.mesh.make_mesh)")
    return [torch.device(d) for d in mesh]
