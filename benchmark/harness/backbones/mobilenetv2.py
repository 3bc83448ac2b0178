"""The port's builder of a MobileNetV2 configuration."""


def builder(model, common):
    from ssdseglib_torch.models.builder import MobileNetV2SsdSegBuilder

    return MobileNetV2SsdSegBuilder(**common)
