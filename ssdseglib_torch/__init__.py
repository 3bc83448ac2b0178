"""ssdseglib_torch: the PyTorch/CUDA port of ssdseglib_tpu for one NVIDIA H100.

Joint object detection (SSDLite) and semantic segmentation (DeepLabV3+) on
MobileNetV2 or ShuffleNetV2 backbones: anchors, ground-truth encoding and
decoding (`datacoder.DataEncoderDecoder`), the three losses, streaming
metrics, training (`train.Trainer`, the loader in `data.pipeline`),
checkpoints, serving with NMS, and the evaluators.  The JAX package's Pallas
kernels are hand-written CUDA kernels here (``csrc/``), built with nvcc on
first use, never on import.

The public surface mirrors the reference package `ssdseglib` and the JAX
package's: every module below is importable as ``ssdseglib_torch.<name>``.
`NOT_PORTED` names the JAX package's modules that have no counterpart yet.
"""

from ssdseglib_torch import boxes
from ssdseglib_torch import config
from ssdseglib_torch import datacoder
from ssdseglib_torch import losses
from ssdseglib_torch import metrics
from ssdseglib_torch import evaluators
from ssdseglib_torch import layers
from ssdseglib_torch import blocks
from ssdseglib_torch import models
from ssdseglib_torch import ops
from ssdseglib_torch import plot

# additions beyond the reference surface
from ssdseglib_torch import checkpoint
from ssdseglib_torch import train

# modules of ssdseglib_tpu's surface not ported yet (ROADMAP.md, Queue 1)
NOT_PORTED = ("export", "keras_import", "parallel")

__version__ = "0.1.0"

__all__ = [
    "boxes",
    "config",
    "datacoder",
    "losses",
    "metrics",
    "evaluators",
    "layers",
    "blocks",
    "models",
    "ops",
    "plot",
    "checkpoint",
    "train",
    "__version__",
]
