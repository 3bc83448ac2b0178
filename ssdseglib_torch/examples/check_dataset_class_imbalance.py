"""Dataset sanity checks on the port: reference notebook
`99-check-dataset-class-imbalance`, as
`examples/99_check_dataset_class_imbalance.py` runs it on the JAX package.

    python -m ssdseglib_torch.examples.check_dataset_class_imbalance \
        [--data data/train.json] [--samples 128] [--num-classes 4] [--output FILE]

Per-class object counts, segmentation pixel shares with the
inverse-frequency loss weights they suggest, and box aspect-ratio (w:h)
percentiles per class: the numbers that justified the reference's anchor
aspect ratios and loss weights.  The samples are a reference-format dataset
JSON (`data/pipeline.load_dataset_json`) or, without ``--data``, synthetic
480x640 warehouse scenes; each is decoded by the loader's host decode
(`data/pipeline._load_sample`).  Host work only: it needs no card.

Prints the tables, then one JSON line with the same numbers; `run` returns
them.
"""

from __future__ import annotations

import argparse
import json
import sys
from collections import Counter
from typing import Optional

import numpy as np

PERCENTILES = (5, 25, 50, 75, 95)
MAX_GROUND_TRUTH = 64


def run(data: Optional[str] = None, samples: int = 128, num_classes: int = 4,
        log_fn=print) -> dict:
    """The checks (the module docstring) over the dataset JSON ``data``, or
    else ``samples`` synthetic scenes; returns the numbers it prints."""
    from ssdseglib_torch.data.pipeline import _load_sample, load_dataset_json
    from ssdseglib_torch.data.synthetic import generate_dataset

    if data:
        dataset = load_dataset_json(data)
    else:
        log_fn("no --data given: using synthetic warehouse scenes")
        dataset = generate_dataset(samples, image_shape=(480, 640))

    box_counts = Counter()
    pixel_counts = np.zeros(num_classes, dtype=np.int64)
    aspect_ratios = {c: [] for c in range(1, num_classes)}
    for sample in dataset:
        _, mask, labels, boxes, valid = _load_sample(sample, max_gt=MAX_GROUND_TRUTH)
        classes, counts = np.unique(mask, return_counts=True)
        for c, n in zip(classes, counts):
            if c < num_classes:
                pixel_counts[c] += int(n)
        for label, box in zip(labels[valid], boxes[valid]):
            box_counts[int(label)] += 1
            w = box[2] - box[0] + 1.0
            h = box[3] - box[1] + 1.0
            if h > 0:
                aspect_ratios[int(label)].append(w / h)

    total_boxes = sum(box_counts.values())
    log_fn(f"\nobject counts ({total_boxes} boxes over {len(dataset)} samples):")
    for c in sorted(box_counts):
        log_fn(f"  class {c}: {box_counts[c]} ({box_counts[c] / total_boxes:.1%})")
    shares = pixel_counts / pixel_counts.sum()
    log_fn("\nsegmentation pixel share:")
    for c in range(num_classes):
        log_fn(f"  class {c}: {shares[c]:.2%}")
    inverse = np.where(pixel_counts > 0, 1.0 / np.maximum(pixel_counts, 1), 0.0)
    weights = inverse / inverse.sum()
    log_fn(f"  suggested inverse-frequency loss weights: {np.round(weights, 3).tolist()}")
    log_fn("\nbox aspect ratio (w:h) percentiles per class:")
    percentiles = {}
    for c, ratios in aspect_ratios.items():
        if not ratios:
            continue
        p = np.percentile(ratios, PERCENTILES)
        percentiles[c] = p.tolist()
        log_fn(f"  class {c}: " + " ".join(f"p{q}={v:.2f}" for q, v in zip(PERCENTILES, p)))
    return {
        "samples": len(dataset),
        "box_counts": {int(c): int(n) for c, n in sorted(box_counts.items())},
        "pixel_counts": pixel_counts.tolist(),
        "pixel_shares": shares.tolist(),
        "inverse_frequency_weights": weights.tolist(),
        "aspect_ratio_percentiles": percentiles,
    }


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--data", type=str, default=None)
    parser.add_argument("--samples", type=int, default=128)
    parser.add_argument("--num-classes", type=int, default=4)
    parser.add_argument("--output", help="also write the JSON line to this file")
    args = parser.parse_args(argv)
    result = run(args.data, args.samples, args.num_classes)
    line = json.dumps(result)
    print(line, flush=True)
    if args.output:
        with open(args.output, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
