"""PyTorch/CUDA port of ssdseglib_tpu: joint SSDLite detection and DeepLabV3+
segmentation serving on MobileNetV2, with a hand-written Hopper kernel for
the fused inverted-residual block."""
