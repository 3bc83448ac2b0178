"""Model zoo: builders mirroring the reference `ssdseglib.models` surface."""

from ssdseglib_torch.models.builder import (
    InferenceModel,
    MobileNetV2SsdSegBuilder,
    ShuffleNetV2SsdSegBuilder,
    SsdSegModel,
    TrainableModel,
    count_parameters,
)
from ssdseglib_torch.models.mobilenetv2 import MobileNetV2Backbone
from ssdseglib_torch.models.shufflenetv2 import ShuffleNetV2Backbone

__all__ = [
    "InferenceModel",
    "MobileNetV2SsdSegBuilder",
    "ShuffleNetV2SsdSegBuilder",
    "SsdSegModel",
    "TrainableModel",
    "count_parameters",
    "MobileNetV2Backbone",
    "ShuffleNetV2Backbone",
]
