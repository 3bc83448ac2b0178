"""The SSD framework walkthrough on the port: reference notebook
`01-ssd-framework-single-shot-detector-for-object-detection`, as
`examples/01_ssd_framework.py` runs it on the JAX package.

    python -m ssdseglib_torch.examples.ssd_framework [--output FILE]

The detection data path end to end on a synthetic warehouse scene: the
warehouse anchors (`DefaultBoundingBoxes`, notebook 03 cell 6's
configuration) rescaled to 480x640, the ground truth encoded against them
(`DataEncoderDecoder`, matching on the card), the positives decoded back to
corners (on the card), and the encoding of the horizontally flipped scene.

Prints the walkthrough's lines, then one JSON line: the anchor count, the
grid and boxes a point of each feature map, the scene's objects, the
positives, the worst corner error of the decode round trip in pixels, the
positives after the flip and the card.  `run` returns the same numbers.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

IMAGE_SHAPE = (480, 640)
# the warehouse anchors (reference notebook 03 cell 6)
ANCHORS = dict(
    feature_maps_shapes=((30, 40), (15, 20), (8, 10), (4, 5)),
    centers_padding_from_borders_percentage=(0.025, 0.05, 0.075, 0.1),
    boxes_scales=(0.15, 0.95),
    additional_square_box=True,
)
ENCODING = dict(num_classes=4, iou_threshold=0.525,
                standard_deviations_centroids_offsets=(0.1, 0.1, 0.2, 0.2))


def run(device="cuda", log_fn=print) -> dict:
    """The walkthrough (the module docstring) on ``device``, the card
    unless the caller asks for the CPU; returns its numbers."""
    from ssdseglib_torch.boxes import DefaultBoundingBoxes
    from ssdseglib_torch.data.synthetic import generate_sample
    from ssdseglib_torch.datacoder import DataEncoderDecoder

    # 1. default bounding boxes ("anchors")
    boxes_default = DefaultBoundingBoxes(**ANCHORS)
    boxes_default.rescale_boxes_coordinates(image_shape=IMAGE_SHAPE)
    corners = boxes_default.get_boxes_coordinates_corners("ssd")
    log_fn(f"total default boxes: {corners.shape[0]}")
    per_map = boxes_default.get_boxes_coordinates_corners("feature-maps")
    boxes_per_map = [[int(m.shape[0]), int(m.shape[1]), int(m.shape[2])] for m in per_map]
    for i, (h, w, k) in enumerate(boxes_per_map):
        log_fn(f"  feature map {i}: grid ({h}, {w}), {k} boxes/point")

    # 2. encoder / decoder
    coder = DataEncoderDecoder(
        image_shape=IMAGE_SHAPE,
        xmin_boxes_default=boxes_default.get_boxes_coordinates_xmin("ssd"),
        ymin_boxes_default=boxes_default.get_boxes_coordinates_ymin("ssd"),
        xmax_boxes_default=boxes_default.get_boxes_coordinates_xmax("ssd"),
        ymax_boxes_default=boxes_default.get_boxes_coordinates_ymax("ssd"),
        device=device, **ENCODING)

    # 3. synthetic scene -> encode -> decode round trip
    sample = generate_sample(0, image_shape=IMAGE_SHAPE)
    log_fn(f"\nsynthetic scene: {len(sample.labels)} objects, labels {sample.labels.tolist()}")
    enc_labels, enc_offsets = coder.encode_ground_truth(sample.labels, sample.boxes)
    matched = enc_labels[:, 0] == 0
    positives = int(matched.sum())
    log_fn(f"anchors matched (positives): {positives} / {enc_labels.shape[0]}")
    decoded = coder.decode_to_corners(torch.from_numpy(enc_offsets).to(device))
    decoded = decoded.cpu().numpy()[matched]
    # each positive's nearest ground-truth box, by its largest corner error
    errors = np.abs(sample.boxes[None, :, :] - decoded[:, None, :]).max(axis=2).min(axis=1)
    worst = float(errors.max()) if len(errors) else 0.0
    log_fn(f"decode round-trip worst corner error: {worst:.5f} px")

    # 4. flips preserve encode / decode consistency
    flipped, _ = coder.encode_ground_truth(sample.labels, sample.boxes, flip_horizontal=True)
    positives_flipped = int((flipped[:, 0] == 0).sum())
    log_fn(f"positives after horizontal flip: {positives_flipped}")
    return {
        "anchors": int(corners.shape[0]), "boxes_per_map": boxes_per_map,
        "objects": int(len(sample.labels)), "labels": sample.labels.tolist(),
        "positives": positives, "decode_worst_corner_error_px": worst,
        "positives_after_flip": positives_flipped, "device": str(device),
    }


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--output", help="also write the JSON line to this file")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("the walkthrough needs a CUDA device; none is available")
    from ssdseglib_torch.examples.train_multitask import card

    result = run()
    result["card"] = card()
    line = json.dumps(result)
    print(line, flush=True)
    if args.output:
        with open(args.output, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
