"""Seeded warehouse-style scenes (a frozen copy of the program's synthetic
generator, ``ssdseglib_torch/data/synthetic.py``, so that the traffic does
not move when the program does): coloured rectangles of classes 1..3 on a
textured background, an exact class-map mask and labelled corner boxes.
Scene ``index`` of ``seed`` is the same on every machine."""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

COLOURS = {1: (200, 40, 40), 2: (40, 200, 40), 3: (40, 40, 200)}


def scene(index: int, seed: int, image_hw=(480, 640), classes: int = 4, max_objects: int = 6):
    """(image (H, W, 3) uint8, mask (H, W) uint8, labels (G,) int32, boxes
    (G, 4) float32 xmin ymin xmax ymax)."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, index]))
    h, w = image_hw
    image = rng.integers(30, 90, size=(h, w, 3), dtype=np.uint8)
    noise = rng.integers(0, 30, size=(h // 8, w // 8, 3), dtype=np.uint8)
    image += np.kron(noise, np.ones((8, 8, 1), dtype=np.uint8))[:h, :w]
    mask = np.zeros((h, w), dtype=np.uint8)
    labels, boxes = [], []
    for _ in range(int(rng.integers(1, max_objects + 1))):
        cls = int(rng.integers(1, classes))
        bw, bh = int(rng.integers(w // 12, w // 3)), int(rng.integers(h // 12, h // 3))
        x0, y0 = int(rng.integers(0, w - bw)), int(rng.integers(0, h - bh))
        x1, y1 = x0 + bw - 1, y0 + bh - 1
        fill = np.clip(np.asarray(COLOURS.get(cls, (150, 150, 150))) + rng.integers(-25, 25, size=3),
                       0, 255).astype(np.uint8)
        image[y0:y1 + 1, x0:x1 + 1] = fill
        mask[y0:y1 + 1, x0:x1 + 1] = cls
        labels.append(cls)
        boxes.append([float(x0), float(y0), float(x1), float(y1)])
    return image, mask, np.asarray(labels, np.int32), np.asarray(boxes, np.float32)


def scenes(count: int, seed: int, image_hw=(480, 640)) -> List[Tuple]:
    return [scene(i, seed, image_hw) for i in range(count)]


def padded(labels: np.ndarray, boxes: np.ndarray, budget: int):
    """Ground truth padded to ``budget`` rows: (labels, boxes, valid)."""
    g = min(len(labels), budget)
    out_l, out_b, out_v = (np.zeros(budget, np.int32), np.zeros((budget, 4), np.float32),
                           np.zeros(budget, bool))
    out_l[:g], out_b[:g], out_v[:g] = labels[:g], boxes[:g], True
    return out_l, out_b, out_v
