"""Plain float32 reference of the benchmark's configurations.

Written from the published architecture (a backbone, each in
``backbones/<name>.py``, with DeepLabV3+ and SSDLite heads, TF "SAME"
padding, Keras-style BatchNorm) in plain PyTorch: no kernel, no fold, no
cache, no batching trick.  It imports nothing of the program under test and
takes nothing the program made; the harness hands both sides the same seeded
raw weights and raw batches.
"""
