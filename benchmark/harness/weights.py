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
overflow.  The trained checkpoint is not in the repository.

Each entry of the state dict is drawn by what holds it: a convolution's
kernel or bias, a BatchNorm's scale, bias, running statistics or count.
Anything else (a linear layer, a free parameter) is refused by name, not
served as zeros: a backbone writes a squeeze-and-excitation's two layers as
1x1 convolutions with biases."""

from __future__ import annotations

from typing import Dict

import numpy as np

import torch
import torch.nn as nn

from benchmark.harness import scenes
from benchmark.reference.model import Network, Norm

_TRUNCATED_STD = 0.87962566103423978  # std of a unit normal cut at +-2
STATISTICS_SCENES = 1_000_000
STATISTICS_BATCH = 8
_CONV = {"weight": "kernel", "bias": "zero"}
_NORM = {"weight": "one", "bias": "uniform", "running_mean": "zero", "running_var": "one",
         "num_batches_tracked": "count"}


def _kinds(net: nn.Module) -> Dict[str, str]:
    """How each entry of ``net``'s state dict is drawn, by the module that
    holds it: 'kernel' (an ``nn.Conv2d``'s weight), 'uniform' (a
    BatchNorm's bias), 'one', 'zero' or 'count'.  Raises on any other."""
    out = {}
    for key, value in net.state_dict().items():
        owner, _, name = key.rpartition(".")
        module = net.get_submodule(owner)
        rule = (_CONV if isinstance(module, nn.Conv2d)
                else _NORM if isinstance(module, nn.BatchNorm2d) else {})
        kind = rule.get(name)
        if kind is None:
            raise ValueError(f"no rule to draw {key!r} ({type(module).__name__}.{name}, "
                             f"shape {tuple(value.shape)}): the harness draws convolutions' "
                             f"kernels and biases and BatchNorms' entries only")
        out[key] = kind
    return out


def draw(model: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    net = Network(model).to("meta")
    template, kind = net.state_dict(), _kinds(net)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    kernels = [k for k in template if kind[k] == "kernel"]
    vectors = [k for k in template if kind[k] == "uniform"]
    normal = torch.randn(sum(template[k].numel() for k in kernels), generator=gen,
                         device=device).clamp_(-2.0, 2.0)
    uniform = torch.rand(sum(template[k].numel() for k in vectors), generator=gen,
                         device=device).add_(0.5)
    out, i, j = {}, 0, 0
    for k, v in template.items():
        if kind[k] == "kernel":
            fan_in = v.shape[1] * v.shape[2] * v.shape[3]
            out[k] = normal[i:i + v.numel()].view(v.shape) * ((1.0 / fan_in) ** 0.5 / _TRUNCATED_STD)
            i += v.numel()
        elif kind[k] == "uniform":
            out[k] = uniform[j:j + v.numel()].view(v.shape)
            j += v.numel()
        elif kind[k] == "count":
            out[k] = torch.zeros((), dtype=torch.int64, device=device)
        elif kind[k] == "one":
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
