"""Device-side ops: ground-truth encoding and decoding, NMS, color
augmentation (the reference's TF-builtin ops, as PyTorch tensor math), and
the wrappers of the hand-written CUDA kernels, which build their library on
first use."""

from ssdseglib_torch.ops import encoding
from ssdseglib_torch.ops import nms
from ssdseglib_torch.ops import color

__all__ = ["encoding", "nms", "color"]
