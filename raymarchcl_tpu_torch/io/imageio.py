"""PNG image I/O (the reference's piksel dependency, core.clj:172-178 /
meshvoxel.clj:73-75)."""

from __future__ import annotations

import numpy as np


def argb_to_rgba(argb: np.ndarray) -> np.ndarray:
    """0xAARRGGBB uint32 (H, W) -> (H, W, 4) uint8 RGBA."""
    argb = np.asarray(argb, dtype=np.uint32)
    return np.stack(
        [(argb >> 16) & 0xFF, (argb >> 8) & 0xFF, argb & 0xFF, (argb >> 24) & 0xFF],
        axis=-1,
    ).astype(np.uint8)


def save_png(argb: np.ndarray, path: str) -> None:
    """Save a packed-ARGB image to PNG."""
    from PIL import Image

    Image.fromarray(argb_to_rgba(argb), mode="RGBA").save(path)


def load_gray(path: str) -> np.ndarray:
    """An image's low byte as (H, W) uint8: what the heatmap generator
    consumes (meshvoxel.clj:79 `(bit-and pixel 255)`, the blue channel of
    ARGB)."""
    from PIL import Image

    img = np.asarray(Image.open(path).convert("RGBA"))
    return img[..., 2].copy()
