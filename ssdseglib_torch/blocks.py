"""Architecture blocks: the reference `ssdseglib.blocks` surface, counterpart
of ssdseglib_tpu/blocks.py.

The reference exposes `deeplabv3plus_encoder`, `deeplabv3plus_decoder` and
`ssdlite` as Keras-graph functions (reference ssdseglib/blocks.py); here they
are the port's ``nn.Module`` classes under those names, beside the conv
primitives they are built from.
"""

from ssdseglib_torch.models.blocks import (
    ConvBN,
    DepthwiseConvBN,
    SepConvBN,
    bilinear_resize,
    channel_shuffle,
)
from ssdseglib_torch.models.heads import (
    DeepLabV3PlusDecoder,
    DeepLabV3PlusEncoder,
    SsdLiteBlock,
    SsdLiteHeads,
)

# reference-surface aliases (ssdseglib/blocks.py:4, :76, :134)
deeplabv3plus_encoder = DeepLabV3PlusEncoder
deeplabv3plus_decoder = DeepLabV3PlusDecoder
ssdlite = SsdLiteBlock

__all__ = [
    "ConvBN",
    "DepthwiseConvBN",
    "SepConvBN",
    "bilinear_resize",
    "channel_shuffle",
    "DeepLabV3PlusDecoder",
    "DeepLabV3PlusEncoder",
    "SsdLiteBlock",
    "SsdLiteHeads",
    "deeplabv3plus_encoder",
    "deeplabv3plus_decoder",
    "ssdlite",
]
