"""`ssdseglib_torch.compat` -- the reference package's surface on the port,
the port's counterpart of the JAX package's `ssdseglib`.

A notebook written for the reference package (reference
ssdseglib/__init__.py:1-9) runs on the port with one changed line:

    import ssdseglib_torch.compat as ssdseglib

What lives here is only the adapter layer; every implementation is in
`ssdseglib_torch.*`.  The adapters do three jobs:

- module aliases with the reference names (`blocks`, `boxes`, `datacoder`,
  `models`, `layers`, `losses`, `metrics`, `evaluators`, `plot`)
- a TF bridge so the reference notebooks' `tf.data` pipelines can call
  `DataEncoderDecoder.read_and_encode` / `augmentation_rgb_channels` /
  `read_image` inside `Dataset.map` (reference notebook 03 cell 8);
  TensorFlow is imported only when a TensorFlow tensor comes in
- a Keras-style model facade (`models.KerasStyleModel`) returned by the
  builders' `get_model_for_training`, plus a `tf.keras.models.load_model`
  shim so checkpoints saved by `model.save(... .keras)` load back
  (reference notebook 03 cells 17/19)

Importing it imports neither TensorFlow nor h5py, nor any JAX module.
"""

from ssdseglib_torch.compat import blocks
from ssdseglib_torch.compat import boxes
from ssdseglib_torch.compat import datacoder
from ssdseglib_torch.compat import evaluators
from ssdseglib_torch.compat import layers
from ssdseglib_torch.compat import losses
from ssdseglib_torch.compat import metrics
from ssdseglib_torch.compat import models
from ssdseglib_torch.compat import plot

# If TensorFlow is already imported (the notebooks import it before
# `import ssdseglib` -- reference notebook 03 cell 2), install the
# `tf.keras.models.load_model` shim so cell 19 can load `.keras` files
# written by `model.save`.  Other files fall through to the original Keras
# loader untouched.
models.install_tf_load_model_shim()

__all__ = [
    "blocks",
    "boxes",
    "datacoder",
    "evaluators",
    "layers",
    "losses",
    "metrics",
    "models",
    "plot",
]
