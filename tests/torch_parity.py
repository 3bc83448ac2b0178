"""Shared set-up of the parity tests between ssdseglib_tpu (JAX, the
reference) and ssdseglib_torch (the PyTorch port): the same weights and
inputs, made with numpy from a seed, go through both packages."""

import math
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
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


def initialise_vector_math() -> None:
    """Makes this process's first call into PyTorch's CPU vector math (MKL's
    VML, behind ``torch.exp`` and its kin) on ONE thread.  When that first
    call runs on several threads of the intra-op pool at once, one thread's
    chunk can come back wrong by up to 1.4e-4 relative (``torch.exp`` right
    after a weight init: in 2 to 7 of 8 processes; never after a first call
    on one thread, nor on a second call): what a race in the library's
    one-time set-up would do.  Run when this module is imported, so before
    any test of a module that imports it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        torch.exp(torch.zeros(4096))
    finally:
        torch.set_num_threads(threads)


initialise_vector_math()


@pytest.fixture(autouse=True, scope="module")
def two_torch_threads():
    """For a test module that imports it: PyTorch on two intra-op threads while
    the module's tests run.  The suite runs in several worker processes at
    once; with a pool of all cores in each, the pools oversubscribe the
    machine and every small op waits at a barrier (measured: a file of small
    CPU tests took fifteen times its stand-alone time under six workers)."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


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


def port_model_and_jax_variables(cfg: ModelConfig = SMALL_CFG, seed: int = 0):
    """The port's eval-mode SsdSegModel, weights drawn from a torch.Generator
    seeded ``seed`` and BatchNorm statistics and biases from uniform(0.5,
    1.5) as `randomize_batchnorm` draws them, and the same weights as the JAX
    package's variables (`weights.to_flax_variables`): the pair of
    `jax_model_and_variables` and `port_model` without the JAX init's
    compile."""
    from ssdseglib_torch.config import ModelConfig as PortModelConfig
    from ssdseglib_torch.models.builder import SsdSegModel
    from ssdseglib_torch.weights import to_flax_variables

    generator = torch.Generator().manual_seed(seed)
    model = SsdSegModel(PortModelConfig(**vars(cfg)), generator)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                for t in (m.running_mean, m.running_var, m.bias):
                    t.copy_(torch.rand(t.shape, generator=generator) + 0.5)
    return model.eval(), to_flax_variables(model.state_dict())


def bf16_ulps(got: torch.Tensor, want: torch.Tensor) -> torch.Tensor:
    """How many bf16 values lie between ``got`` and ``want`` (bf16 tensors),
    element by element: their distance in bf16 ulps."""
    def ordered(t):
        bits = t.contiguous().view(torch.int16).int()
        return torch.where(bits < 0, -(bits & 0x7fff), bits)

    return (ordered(got) - ordered(want)).abs()


def images(seed: int, shape, dtype=np.float32):
    rng = np.random.default_rng(seed)
    if dtype == np.uint8:
        return rng.integers(0, 256, shape, dtype=np.uint8)
    return rng.uniform(0, 255, shape).astype(dtype)


def make_stem_folded(rng, scale: float = 0.4):
    """Random folded (HWIO kernel, bias) pairs of the stem and block 1, the
    channel plan 3 -> 32 -> 16 -> 96 -> 24, as the JAX package's stem tests
    draw them."""
    def k(*shape):
        return rng.normal(0, scale, shape).astype(np.float32)

    return {
        "backbone-block0-expand": (k(3, 3, 3, 32), k(32)),
        "backbone-block0-depthwise": (k(3, 3, 1, 32), k(32)),
        "backbone-block0-project": (k(1, 1, 32, 16), k(16)),
        "backbone-block1-expand": (k(1, 1, 16, 96), k(96)),
        "backbone-block1-depthwise": (k(3, 3, 1, 96), k(96)),
        "backbone-block1-project": (k(1, 1, 96, 24), k(24)),
    }


def port_folded(folded_hwio, dtype=torch.float32):
    """The JAX package's folded dict (HWIO kernels) as the port's: OIHW
    torch tensors in ``dtype``."""
    return {
        name: (torch.from_numpy(np.ascontiguousarray(k.transpose(3, 2, 0, 1))).to(dtype),
               torch.from_numpy(b).to(dtype))
        for name, (k, b) in folded_hwio.items()
    }


def random_detections(rng, batch=3, n=128, num_classes=4, spread=100.0):
    """Decoded boxes (B, N, 4) in (ymin, xmin, ymax, xmax) order and softmax
    class probabilities (B, N, C) for the NMS tests."""
    cx = rng.uniform(0, spread, (batch, n))
    cy = rng.uniform(0, spread, (batch, n))
    w = rng.uniform(5, 40, (batch, n))
    h = rng.uniform(5, 40, (batch, n))
    boxes_yx = np.stack(
        [cy - h / 2, cx - w / 2, cy + h / 2, cx + w / 2], axis=-1
    ).astype(np.float32)
    logits = rng.normal(size=(batch, n, num_classes)) * 3.0
    scores = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    return boxes_yx, scores.astype(np.float32)


CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "ssdseglib_torch", "csrc")


def source_constants(source: str, *names: str) -> dict:
    """Integer constants ``constexpr int NAME = value`` of a kernel source in
    ``ssdseglib_torch/csrc``, so that a test emulating the kernel follows its
    built-in geometry."""
    with open(os.path.join(CSRC, source)) as f:
        text = f.read()
    return {name: int(re.search(rf"\b{name} = (\d+)", text).group(1)) for name in names}


def ticket_sum(partials):
    """`finish` (csrc/common.cuh): (n, M) per-CTA partials summed in groups
    of ceil(sqrt(n)) consecutive CTAs in CTA order, then the groups in group
    order."""
    n = partials.shape[0]
    group = math.isqrt(n - 1) + 1 if n > 1 else 1
    sums = []
    for g0 in range(0, n, group):
        s = torch.zeros_like(partials[0])
        for p in range(g0, min(g0 + group, n)):
            s = s + partials[p]
        sums.append(s)
    total = torch.zeros_like(partials[0])
    for s in sums:
        total = total + s
    return total
