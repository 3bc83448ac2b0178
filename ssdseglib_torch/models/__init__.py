"""Model zoo: builders mirroring the reference `ssdseglib.models` surface."""

from ssdseglib_torch.models.builder import (
    InferenceModel,
    MobileNetV2SsdSegBuilder,
    MobileNetV3LargeSsdSegBuilder,
    ShuffleNetV2SsdSegBuilder,
    SsdSegModel,
    TrainableModel,
    count_parameters,
)
from ssdseglib_torch.models.mobilenetv2 import MobileNetV2Backbone
from ssdseglib_torch.models.mobilenetv3 import MobileNetV3LargeBackbone
from ssdseglib_torch.models.shufflenetv2 import ShuffleNetV2Backbone

# the JAX package's surface; MobileNetV3LargeSsdSegBuilder and
# MobileNetV3LargeBackbone, imported above, are the port's own
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
