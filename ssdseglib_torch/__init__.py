"""ssdseglib_torch: the PyTorch/CUDA port of ssdseglib_tpu for one NVIDIA H100.

Joint object detection (SSDLite) and semantic segmentation (DeepLabV3+) on
MobileNetV2 or ShuffleNetV2 backbones: anchors, ground-truth encoding and
decoding (`datacoder.DataEncoderDecoder`), the three losses, streaming
metrics, training (`train.Trainer`, the loader in `data.pipeline`),
checkpoints, serving with NMS, Keras weight import (`keras_import`),
self-contained serving bundles (`export`), data and spatial (H-axis)
parallelism over ``torch.distributed`` (`parallel`), the evaluators, and the
reference package's Keras-style surface (`compat`: ``import
ssdseglib_torch.compat as ssdseglib``).  The JAX
package's Pallas kernels are hand-written CUDA kernels here (``csrc/``),
built with nvcc on first use, never on import.

The public surface mirrors the reference package `ssdseglib` and the JAX
package's: every module in ``__all__`` is importable as
``ssdseglib_torch.<name>``.  The modules load at first access, so a process
that only reloads a serving bundle (`export.load_serving_bundle`) imports no
model-building code.  `NOT_PORTED` names the parts of the JAX package's
surface that have no counterpart yet.
"""

import importlib

# parts of ssdseglib_tpu's surface not ported yet (ROADMAP.md, Queue 1)
NOT_PORTED = ()

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
    # additions beyond the reference surface
    "checkpoint",
    "compat",
    "export",
    "keras_import",
    "parallel",
    "train",
    "__version__",
]


def __getattr__(name: str):
    if name in __all__:
        return importlib.import_module(f"{__name__}.{name}")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(set(globals()) | set(__all__))
