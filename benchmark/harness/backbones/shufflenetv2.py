"""The port's builder of a ShuffleNetV2 configuration, with notebook 03's
three options."""


def builder(model, common):
    from ssdseglib_torch.models.builder import ShuffleNetV2SsdSegBuilder

    return ShuffleNetV2SsdSegBuilder(
        model_size=model["shufflenet_size"],
        use_additional_depthwise_convolution=model["shufflenet_extra_depthwise"],
        use_residual_connections=model["shufflenet_residuals"], **common)
