"""Example datasets (a copy of the JAX package's ``examples/_data.py``).

The reference examples use the ViBE-Z 72hpf zebrafish h5 dataset and BraTS
MRI nifti volumes, neither of which is shipped (reference README.md:45,
examples/h5-data/.gitkeep). Like the reference, these examples load the
real data when present; otherwise they generate a synthetic two-channel
stand-in (an anatomically-shaped blob "brain" plus a thin filamentous
"structure" channel) so every example runs out of the box.
"""

from __future__ import annotations

import os

import numpy as np

# the data directory the JAX package's examples read, examples/h5-data at the
# root of the repo, so that a dataset put there serves both (read, not imported)
DATA_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "examples", "h5-data")
VIBE_Z = os.path.join(DATA_DIR, "ViBE-Z_72hpf_v1.h5")


def synthetic_zebrafish(n: int = 96, seed: int = 0):
    """Two channels + element size, shaped (D, H, W) = (z, y, x).

    main: ellipsoidal 'brain' with internal lobes; structure: a bright
    curved filament bundle. Values in [0, 1], float32.
    """
    rng = np.random.default_rng(seed)
    d, h, w = n // 2, (3 * n) // 4, n
    z, y, x = np.mgrid[0:d, 0:h, 0:w].astype(np.float32)
    zc, yc, xc = (d - 1) / 2, (h - 1) / 2, (w - 1) / 2

    # main channel: smooth ellipsoid + lobes
    r2 = ((x - xc) / (0.45 * w)) ** 2 + ((y - yc) / (0.4 * h)) ** 2 + ((z - zc) / (0.4 * d)) ** 2
    main = np.exp(-2.5 * r2)
    for _ in range(6):
        cx, cy, cz = rng.uniform(0.25, 0.75, 3) * (w, h, d)
        s = rng.uniform(0.06, 0.14) * n
        main += 0.5 * np.exp(-(((x - cx) ** 2 + (y - cy) ** 2 + (z - cz) ** 2) / (2 * s * s)))
    main = (main / main.max()).astype(np.float32)

    # structure channel: a helical filament through the volume
    t = np.linspace(0, 1, 400, dtype=np.float32)
    px = (0.2 + 0.6 * t) * w
    py = yc + 0.25 * h * np.sin(6.0 * t)
    pz = zc + 0.25 * d * np.cos(5.0 * t)
    structure = np.zeros((d, h, w), np.float32)
    sigma = max(1.5, 0.02 * n)
    for cx, cy, cz in zip(px, py, pz):
        x0, x1 = int(max(0, cx - 3 * sigma)), int(min(w, cx + 3 * sigma + 1))
        y0, y1 = int(max(0, cy - 3 * sigma)), int(min(h, cy + 3 * sigma + 1))
        z0, z1 = int(max(0, cz - 3 * sigma)), int(min(d, cz + 3 * sigma + 1))
        if x0 >= x1 or y0 >= y1 or z0 >= z1:
            continue
        zz, yy, xx = np.mgrid[z0:z1, y0:y1, x0:x1].astype(np.float32)
        g = np.exp(-(((xx - cx) ** 2 + (yy - cy) ** 2 + (zz - cz) ** 2) / (2 * sigma * sigma)))
        structure[z0:z1, y0:y1, x0:x1] = np.maximum(structure[z0:z1, y0:y1, x0:x1], g)
    structure = structure.astype(np.float32)

    element_size_um = (1.0, 1.0, 2.0)  # (x, y, z) — anisotropic like microscopy
    return main, structure, element_size_um


def load_channels(n: int = 96):
    """(main, structure, element_size_um) from the real h5 if present,
    else synthetic."""
    if os.path.exists(VIBE_Z):
        try:
            import h5py

            with h5py.File(VIBE_Z, "r") as f:
                main = np.asarray(f["/anatomy/average_brain"], np.float32)
                structure = np.asarray(f["/expression/3A10"], np.float32)
                es = np.asarray(f["/anatomy/average_brain"].attrs["element_size_um"])
                # h5 stores (z, y, x); our convention is (x, y, z)
                element_size_um = tuple(float(v) for v in es[::-1])
            main /= max(main.max(), 1e-6)
            structure /= max(structure.max(), 1e-6)
            return main, structure, element_size_um
        except Exception as e:  # pragma: no cover
            print(f"failed to read {VIBE_Z} ({e}); using synthetic data")
    return synthetic_zebrafish(n)


def save_image(path: str, img: np.ndarray) -> None:
    """Save an (H, W, 3) float image as PNG (PIL) or .npy fallback."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    arr = np.clip(np.asarray(img, np.float32), 0.0, 1.0)
    try:
        from PIL import Image

        Image.fromarray((arr * 255).astype(np.uint8)).save(path)
    except Exception:
        np.save(path + ".npy", arr)
