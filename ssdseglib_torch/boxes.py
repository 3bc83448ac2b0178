"""Default bounding boxes ("anchors") and coordinate conversions.

Copy of ssdseglib_tpu/boxes.py (pure NumPy), counterpart of reference
ssdseglib/boxes.py.  Anchor generation is a one-time host-side precompute
(vectorized — no per-map Python math loops beyond the map list itself); the
serving path uploads the resulting arrays to the device once.

Conventions preserved from the reference (needed for checkpoint/metric
parity):
- pixel-index convention everywhere: ``width = xmax - xmin + 1``
  (reference boxes.py:391-445)
- per-map box size keyed on ``min(feature_map_shape)`` (reference
  boxes.py:97)
- additional square box with scale ``sqrt(s_k * s_{k+1})`` (reference
  boxes.py:104-105)
- rescale factor ``(image_dim - 1) / (fm_dim - 1)`` (reference
  boxes.py:167-168)

Fixed (documented) reference quirk: reference
``rescale_boxes_coordinates`` mutates its internal array in place, so calling
it twice double-scales the anchors (reference boxes.py:162-177).  Here
rescaling is a pure function of the unit-scale anchors; repeat calls are
idempotent.
"""

from __future__ import annotations

import math
from typing import List, Literal, Sequence, Tuple, Union

import numpy as np

from ssdseglib_torch.config import AnchorsConfig

Array = np.ndarray
CoordsStyle = Literal["ssd", "feature-maps"]

_CORNER_INDEX = {"xmin": 0, "ymin": 1, "xmax": 2, "ymax": 3}
_CENTROID_INDEX = {"center-x": 0, "center-y": 1, "width": 2, "height": 3}


# ---------------------------------------------------------------------------
# coordinate conversions (free functions, same math as reference
# boxes.py:391-445; array-library agnostic: work for numpy and torch)
# ---------------------------------------------------------------------------

def coordinates_corners_to_centroids(xmin, ymin, xmax, ymax):
    """Corners -> centroids with the +1 pixel-index convention."""
    center_x = (xmax + xmin) / 2.0
    center_y = (ymax + ymin) / 2.0
    width = xmax - xmin + 1.0
    height = ymax - ymin + 1.0
    return center_x, center_y, width, height


def coordinates_centroids_to_corners(center_x, center_y, width, height):
    """Centroids -> corners with the +1 pixel-index convention."""
    xmin = center_x - (width - 1.0) / 2.0
    ymin = center_y - (height - 1.0) / 2.0
    xmax = center_x + (width - 1.0) / 2.0
    ymax = center_y + (height - 1.0) / 2.0
    return xmin, ymin, xmax, ymax


# ---------------------------------------------------------------------------
# anchor generation
# ---------------------------------------------------------------------------

def _generate_unit_scale_boxes(cfg: AnchorsConfig) -> List[Array]:
    """Per-feature-map anchors in feature-map pixel coordinates.

    Returns one array per feature map with shape (fm_h, fm_w, n_boxes, 4) in
    corners layout (xmin, ymin, xmax, ymax).  Same geometry as reference
    boxes.py:74-151, vectorized with broadcasting.
    """
    scales = np.linspace(
        cfg.boxes_scales[0], cfg.boxes_scales[1], len(cfg.feature_maps_shapes) + 1
    )
    per_map = []
    for map_index, (fm_shape, aspect_ratios, padding) in enumerate(
        zip(
            cfg.feature_maps_shapes,
            cfg.feature_maps_aspect_ratios,
            cfg.centers_padding_from_borders,
        )
    ):
        scale_current = scales[map_index]
        scale_next = scales[map_index + 1]
        fm_size = min(fm_shape)

        # box shapes (height, width) per aspect ratio, optional extra square
        shapes = [
            (
                fm_size * scale_current / math.sqrt(ar),
                fm_size * scale_current * math.sqrt(ar),
            )
            for ar in aspect_ratios
        ]
        if cfg.additional_square_box:
            side = fm_size * math.sqrt(scale_current * scale_next)
            shapes.append((side, side))
        shapes = np.asarray(shapes, dtype=np.float64)  # (n_boxes, 2) as (h, w)

        # centers as pixel indexes, padded away from borders
        def _centers(dim: int) -> Array:
            if dim == 1:
                return np.array([0.5])
            pad = padding * (dim - 1.0)
            return np.linspace(pad, dim - 1.0 - pad, num=dim)

        cy = _centers(fm_shape[0])[:, None, None]  # (h, 1, 1)
        cx = _centers(fm_shape[1])[None, :, None]  # (1, w, 1)
        half_w = (shapes[None, None, :, 1] - 1.0) / 2.0
        half_h = (shapes[None, None, :, 0] - 1.0) / 2.0

        boxes = np.stack(
            np.broadcast_arrays(cx - half_w, cy - half_h, cx + half_w, cy + half_h),
            axis=-1,
        ).astype(np.float32)
        per_map.append(boxes)
    return per_map


def _rescale_boxes(
    unit_boxes: Sequence[Array],
    feature_maps_shapes: Sequence[Tuple[int, int]],
    image_shape: Tuple[int, int],
) -> List[Array]:
    """Rescale unit anchors to image resolution — pure, idempotent.

    Factor is ``(image_dim - 1) / (fm_dim - 1)`` treating coordinates as pixel
    indexes (reference boxes.py:167-168); a 1-wide map divides by 1.
    """
    out = []
    for boxes, fm_shape in zip(unit_boxes, feature_maps_shapes):
        fx = (image_shape[1] - 1) / (fm_shape[1] - 1 if fm_shape[1] > 1 else 1)
        fy = (image_shape[0] - 1) / (fm_shape[0] - 1 if fm_shape[0] > 1 else 1)
        out.append((boxes * np.array([fx, fy, fx, fy], dtype=np.float32)))
    return out


class DefaultBoundingBoxes:
    """Anchor generator mirroring the reference public API.

    Reference: ssdseglib/boxes.py:5 (`DefaultBoundingBoxes`).  Accepts the
    same constructor arguments, exposes the same ten getters with the same
    'ssd' / 'feature-maps' styles and flattening order
    (fm-major, then row-major (h, w, box)).
    """

    def __init__(
        self,
        feature_maps_shapes: Tuple[Tuple[int, int], ...],
        feature_maps_aspect_ratios: Union[
            Tuple[float, ...], Tuple[Tuple[float, ...], ...]
        ] = (1, 2, 3, 1 / 2, 1 / 3),
        boxes_scales: Tuple[float, float] = (0.2, 0.9),
        centers_padding_from_borders_percentage: Union[float, Tuple[float, ...]] = 0.05,
        additional_square_box: bool = True,
    ) -> None:
        if isinstance(centers_padding_from_borders_percentage, float):
            paddings = (centers_padding_from_borders_percentage,) * len(
                feature_maps_shapes
            )
        else:
            paddings = tuple(centers_padding_from_borders_percentage)

        if all(isinstance(item, (int, float)) for item in feature_maps_aspect_ratios):
            aspect_ratios = tuple(
                tuple(float(a) for a in feature_maps_aspect_ratios)
                for _ in feature_maps_shapes
            )
        else:
            aspect_ratios = tuple(
                tuple(float(a) for a in ars) for ars in feature_maps_aspect_ratios
            )

        self.config = AnchorsConfig(
            feature_maps_shapes=tuple(tuple(s) for s in feature_maps_shapes),
            feature_maps_aspect_ratios=aspect_ratios,
            boxes_scales=tuple(boxes_scales),
            centers_padding_from_borders=paddings,
            additional_square_box=additional_square_box,
        )
        self.feature_maps_shapes = self.config.feature_maps_shapes
        self.feature_maps_aspect_ratios = self.config.feature_maps_aspect_ratios
        self.additional_square_box = additional_square_box
        self.boxes_scales = np.linspace(
            boxes_scales[0], boxes_scales[1], len(feature_maps_shapes) + 1
        )

        # unit-scale anchors, never mutated
        self._feature_maps_boxes = _generate_unit_scale_boxes(self.config)
        # image-scale anchors, set by rescale_boxes_coordinates
        self.feature_maps_boxes: List[Array] = None

    # -- scaling ----------------------------------------------------------
    def rescale_boxes_coordinates(self, image_shape: Tuple[int, int]) -> None:
        """Rescale anchors to ``image_shape`` (height, width).  Idempotent."""
        self.feature_maps_boxes = _rescale_boxes(
            self._feature_maps_boxes, self.feature_maps_shapes, image_shape
        )

    def _require_scaled(self) -> List[Array]:
        if self.feature_maps_boxes is None:
            raise ValueError(
                "call rescale_boxes_coordinates(image_shape) before requesting "
                "coordinates"
            )
        return self.feature_maps_boxes

    # -- getters ----------------------------------------------------------
    def _corners(self, index, style: CoordsStyle):
        per_map = tuple(b[..., index] for b in self._require_scaled())
        if style == "ssd":
            shape = (-1, 4) if isinstance(index, list) else (-1,)
            return np.concatenate([m.reshape(shape) for m in per_map], axis=0)
        return per_map

    def _centroids(self, index, style: CoordsStyle):
        per_map = []
        for b in self._require_scaled():
            cx, cy, w, h = coordinates_corners_to_centroids(
                b[..., 0], b[..., 1], b[..., 2], b[..., 3]
            )
            per_map.append(np.stack([cx, cy, w, h], axis=-1)[..., index])
        if style == "ssd":
            shape = (-1, 4) if isinstance(index, list) else (-1,)
            return np.concatenate([m.reshape(shape) for m in per_map], axis=0)
        return tuple(per_map)

    def get_boxes_coordinates_corners(self, coordinates_style: CoordsStyle):
        return self._corners([0, 1, 2, 3], coordinates_style)

    def get_boxes_coordinates_xmin(self, coordinates_style: CoordsStyle):
        return self._corners(_CORNER_INDEX["xmin"], coordinates_style)

    def get_boxes_coordinates_ymin(self, coordinates_style: CoordsStyle):
        return self._corners(_CORNER_INDEX["ymin"], coordinates_style)

    def get_boxes_coordinates_xmax(self, coordinates_style: CoordsStyle):
        return self._corners(_CORNER_INDEX["xmax"], coordinates_style)

    def get_boxes_coordinates_ymax(self, coordinates_style: CoordsStyle):
        return self._corners(_CORNER_INDEX["ymax"], coordinates_style)

    def get_boxes_coordinates_centroids(self, coordinates_style: CoordsStyle):
        return self._centroids([0, 1, 2, 3], coordinates_style)

    def get_boxes_coordinates_center_x(self, coordinates_style: CoordsStyle):
        return self._centroids(_CENTROID_INDEX["center-x"], coordinates_style)

    def get_boxes_coordinates_center_y(self, coordinates_style: CoordsStyle):
        return self._centroids(_CENTROID_INDEX["center-y"], coordinates_style)

    def get_boxes_coordinates_width(self, coordinates_style: CoordsStyle):
        return self._centroids(_CENTROID_INDEX["width"], coordinates_style)

    def get_boxes_coordinates_height(self, coordinates_style: CoordsStyle):
        return self._centroids(_CENTROID_INDEX["height"], coordinates_style)

    # -- TPU-native convenience -------------------------------------------
    def anchors(self) -> "Anchors":
        """Bundle the flat image-scale anchors for the jitted device ops."""
        corners = self.get_boxes_coordinates_corners("ssd")
        centroids = self.get_boxes_coordinates_centroids("ssd")
        return Anchors(corners=corners, centroids=centroids)


class Anchors:
    """Immutable flat anchor bundle fed to the device-side ops.

    Both layouts are precomputed once; all fields are (N, 4) / (N,) float32
    NumPy arrays that jit closes over as constants.
    """

    def __init__(self, corners: Array, centroids: Array):
        self.corners = np.asarray(corners, dtype=np.float32)
        self.centroids = np.asarray(centroids, dtype=np.float32)
        self.xmin = self.corners[:, 0]
        self.ymin = self.corners[:, 1]
        self.xmax = self.corners[:, 2]
        self.ymax = self.corners[:, 3]
        self.center_x = self.centroids[:, 0]
        self.center_y = self.centroids[:, 1]
        self.width = self.centroids[:, 2]
        self.height = self.centroids[:, 3]
        # +1 pixel-index-convention area (reference datacoder.py:111-114)
        self.area = (self.xmax - self.xmin + 1.0) * (self.ymax - self.ymin + 1.0)

    @property
    def total_boxes(self) -> int:
        return self.corners.shape[0]

    @classmethod
    def from_config(
        cls, cfg: AnchorsConfig, image_shape: Tuple[int, int]
    ) -> "Anchors":
        dbb = DefaultBoundingBoxes(
            feature_maps_shapes=cfg.feature_maps_shapes,
            feature_maps_aspect_ratios=cfg.feature_maps_aspect_ratios,
            boxes_scales=cfg.boxes_scales,
            centers_padding_from_borders_percentage=cfg.centers_padding_from_borders,
            additional_square_box=cfg.additional_square_box,
        )
        dbb.rescale_boxes_coordinates(image_shape)
        return dbb.anchors()
