"""The port's builder of a MobileNetV3-Large configuration."""


def builder(model, common):
    from ssdseglib_torch.models.builder import MobileNetV3LargeSsdSegBuilder

    return MobileNetV3LargeSsdSegBuilder(**common)
