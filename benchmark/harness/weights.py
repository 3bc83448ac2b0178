"""Seeded raw weights of a configuration, made on the device in a few calls.

Names and shapes come from the reference network on the meta device (the
program's ``SsdSegModel`` holds the same names).  Convolution kernels: a
normal of variance 1 / fan_in truncated at two standard deviations (Flax's
lecun_normal); convolution biases 0; BatchNorm scale 1 and bias uniform in
[0.5, 1.5), so that folding matters and the ReLUs stay alive through the
heads.  The running statistics are then measured, as a trained network's
are: one train-mode forward of the plain reference over a batch of the
seed's scenes (indices from ``STATISTICS_SCENES`` on, never served) sets
each BatchNorm's running mean and (biased) variance to its input's.  With
statistics drawn at random instead, the uncapped ReLUs of the ShuffleNetV2
heads grow the activations layer after layer until the decoded boxes
overflow.  The trained checkpoint is not in the repository."""

from __future__ import annotations

from typing import Dict

import numpy as np

import torch

from benchmark.harness import scenes
from benchmark.reference.model import Network, Norm

_TRUNCATED_STD = 0.87962566103423978  # std of a unit normal cut at +-2
STATISTICS_SCENES = 1_000_000
STATISTICS_BATCH = 8


def draw(model: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    template = Network(model).to("meta").state_dict()
    gen = torch.Generator(device=device).manual_seed(int(seed))
    kernels = [k for k, v in template.items() if k.endswith("weight") and v.dim() == 4]
    vectors = [k for k in template if k.endswith("batchnorm.bias")]
    normal = torch.randn(sum(template[k].numel() for k in kernels), generator=gen,
                         device=device).clamp_(-2.0, 2.0)
    uniform = torch.rand(sum(template[k].numel() for k in vectors), generator=gen,
                         device=device).add_(0.5)
    out, i, j = {}, 0, 0
    for k, v in template.items():
        if k in kernels:
            fan_in = v.shape[1] * v.shape[2] * v.shape[3]
            out[k] = normal[i:i + v.numel()].view(v.shape) * ((1.0 / fan_in) ** 0.5 / _TRUNCATED_STD)
            i += v.numel()
        elif k in vectors:
            out[k] = uniform[j:j + v.numel()].view(v.shape)
            j += v.numel()
        elif k.endswith("num_batches_tracked"):
            out[k] = torch.zeros((), dtype=torch.int64, device=device)
        elif k.endswith(("batchnorm.weight", "running_var")):
            out[k] = torch.ones(v.shape, device=device)
        else:  # a convolution's bias, a running mean until measured
            out[k] = torch.zeros(v.shape, device=device)
    _measure_statistics(model, out, seed, device)
    return out


@torch.no_grad()
def _measure_statistics(model: Dict, weights: Dict[str, torch.Tensor], seed: int, device) -> None:
    net = Network(model).to(device)
    net.load_state_dict(weights)
    net.train()
    names = {m: n for n, m in net.named_modules() if isinstance(m, Norm)}

    def record(module, inputs):
        x = inputs[0]
        mean = x.mean(dim=(0, 2, 3))
        weights[f"{names[module]}.running_mean"].copy_(mean)
        weights[f"{names[module]}.running_var"].copy_(
            (x - mean.view(1, -1, 1, 1)).square().mean(dim=(0, 2, 3)))

    hooks = [m.register_forward_pre_hook(record) for m in names]
    hw = model["input_image_shape"][:2]
    images = [scenes.scene(STATISTICS_SCENES + i, seed, hw)[0] for i in range(STATISTICS_BATCH)]
    try:
        net(torch.from_numpy(np.stack(images)).to(device).float())
    finally:
        for h in hooks:
            h.remove()
