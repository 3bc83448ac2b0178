"""Synthetic warehouse-style dataset (copy of ssdseglib_tpu/data/synthetic.py,
pure NumPy).

The reference's images are proprietary and absent from the mount
(reference data/.gitignore:1-5, README.md:38) — only path-metadata JSONs
ship.  This module generates deterministic synthetic scenes with the same
structure (RGB image, class-map mask, labeled boxes) so the full train /
eval / benchmark path runs end-to-end without the private data.

Each sample: colored rectangles for classes 1..num_classes-1 on a textured
background; the mask and boxes are exact by construction.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np


@dataclasses.dataclass
class SyntheticSample:
    image: np.ndarray  # (H, W, 3) uint8
    mask: np.ndarray  # (H, W) uint8 class map
    labels: np.ndarray  # (G,) int32
    boxes: np.ndarray  # (G, 4) float32 corners (xmin, ymin, xmax, ymax)


def generate_sample(
    index: int,
    image_shape: Tuple[int, int] = (480, 640),
    num_classes: int = 4,
    max_objects: int = 6,
    seed: int = 0,
    non_overlapping: bool = False,
) -> SyntheticSample:
    """Deterministic synthetic scene for a given index.

    non_overlapping: rejection-sample object placements so boxes never
    intersect.  The default scenes draw objects over each other while
    keeping every full-extent box/label — occlusion-noisy ground truth
    (fine for pipeline tests, a hard ceiling for detection mAP); the
    non-overlapping variant gives exact ground truth for
    learning-demonstration runs (examples/04)."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, index]))
    h, w = image_shape

    # textured background
    image = rng.integers(30, 90, size=(h, w, 3), dtype=np.uint8)
    noise = rng.integers(0, 30, size=(h // 8, w // 8, 3), dtype=np.uint8)
    image += np.kron(noise, np.ones((8, 8, 1), dtype=np.uint8))[:h, :w]
    mask = np.zeros((h, w), dtype=np.uint8)

    class_colors = {
        1: (200, 40, 40),
        2: (40, 200, 40),
        3: (40, 40, 200),
    }

    n_objects = int(rng.integers(1, max_objects + 1))
    labels: List[int] = []
    boxes: List[List[float]] = []
    for _ in range(n_objects):
        cls = int(rng.integers(1, num_classes))
        placed = False
        for _attempt in range(20 if non_overlapping else 1):
            bw = int(rng.integers(w // 12, w // 3))
            bh = int(rng.integers(h // 12, h // 3))
            x0 = int(rng.integers(0, w - bw))
            y0 = int(rng.integers(0, h - bh))
            x1, y1 = x0 + bw - 1, y0 + bh - 1
            if not non_overlapping:
                placed = True
                break
            clear = all(
                x1 < b[0] - 4 or x0 > b[2] + 4 or y1 < b[1] - 4 or y0 > b[3] + 4
                for b in boxes
            )
            if clear:
                placed = True
                break
        if not placed:
            continue
        color = class_colors.get(cls, (150, 150, 150))
        jitter = rng.integers(-25, 25, size=3)
        fill = np.clip(np.asarray(color) + jitter, 0, 255).astype(np.uint8)
        image[y0 : y1 + 1, x0 : x1 + 1] = fill
        mask[y0 : y1 + 1, x0 : x1 + 1] = cls
        labels.append(cls)
        boxes.append([float(x0), float(y0), float(x1), float(y1)])

    return SyntheticSample(
        image=image,
        mask=mask,
        labels=np.asarray(labels, dtype=np.int32),
        boxes=np.asarray(boxes, dtype=np.float32),
    )


def generate_dataset(
    num_samples: int,
    image_shape: Tuple[int, int] = (480, 640),
    num_classes: int = 4,
    seed: int = 0,
    non_overlapping: bool = False,
) -> List[SyntheticSample]:
    return [
        generate_sample(
            i, image_shape=image_shape, num_classes=num_classes, seed=seed,
            non_overlapping=non_overlapping,
        )
        for i in range(num_samples)
    ]
