"""Shared set-up of the parity tests between ssdseglib_tpu (JAX, the
reference) and ssdseglib_torch (the PyTorch port): the same weights and
inputs, made with numpy from a seed, go through both packages."""

import jax
import jax.numpy as jnp
import numpy as np
import torch
from flax.traverse_util import flatten_dict, unflatten_dict

from ssdseglib_tpu.config import ModelConfig

SMALL_CFG = ModelConfig(
    input_image_shape=(96, 128, 3),
    number_of_classes=4,
    boxes_per_point=(6, 6, 6, 6),
    backbone="mobilenetv2",
    segmentation_dilation_rates=(3, 6, 12),
)


def randomize_batchnorm(variables, seed: int = 0):
    """Non-trivial BN so folding matters: running mean and var drawn from
    uniform(0.5, 1.5) as the JAX package's fused-path tests do, and the BN
    bias from uniform(0.5, 1.5) too, which keeps the ReLUs alive through
    the heads (with zero bias the random-init mask is uniform 0.25)."""
    rng = np.random.default_rng(seed)
    stats = jax.tree_util.tree_map(
        lambda x: rng.uniform(0.5, 1.5, x.shape).astype(np.float32),
        variables["batch_stats"],
    )
    params = {
        path: (
            rng.uniform(0.5, 1.5, leaf.shape).astype(np.float32)
            if path[-2:] == ("batchnorm", "bias")
            else np.asarray(leaf)
        )
        for path, leaf in flatten_dict(variables["params"]).items()
    }
    return {"params": unflatten_dict(params), "batch_stats": stats}


def jax_model_and_variables(cfg: ModelConfig = SMALL_CFG, seed: int = 0):
    """The JAX SsdSegModel and its variables: ``init(jax.random.key(seed))``
    plus `randomize_batchnorm`."""
    from ssdseglib_tpu.models.builder import SsdSegModel

    module = SsdSegModel(cfg=cfg)
    shape = (1,) + tuple(cfg.input_image_shape)
    variables = jax.jit(
        lambda key: module.init(key, jnp.zeros(shape), train=False)
    )(jax.random.key(seed))
    return module, randomize_batchnorm(variables, seed)


def port_model(cfg: ModelConfig, variables):
    """The port's eval-mode SsdSegModel holding the bridged JAX weights."""
    from ssdseglib_torch.config import ModelConfig as PortModelConfig
    from ssdseglib_torch.models.builder import SsdSegModel
    from ssdseglib_torch.weights import from_flax_variables

    model = SsdSegModel(
        PortModelConfig(**vars(cfg)), torch.Generator().manual_seed(0)
    )
    model.load_state_dict(from_flax_variables(variables))
    return model


def images(seed: int, shape, dtype=np.float32):
    rng = np.random.default_rng(seed)
    if dtype == np.uint8:
        return rng.integers(0, 256, shape, dtype=np.uint8)
    return rng.uniform(0, 255, shape).astype(dtype)
