"""Weight bridge between the JAX package's Flax variables and the port's
PyTorch ``state_dict``.

The port's modules mirror the Flax module tree name for name, so a Flax
path ``params/backbone/backbone-block3-expand/conv/kernel`` is the torch key
``backbone.backbone-block3-expand.conv.weight``.  The bridge is a rename
plus a transpose:

    kernel (kh, kw, I, O) HWIO  <->  weight (O, I, kh, kw) OIHW
        (a depthwise kernel (kh, kw, 1, C) becomes (C, 1, kh, kw))
    batchnorm scale / bias      <->  weight / bias
    batch_stats mean / var      <->  running_mean / running_var

Both directions take and give NumPy values; ``num_batches_tracked`` (which
Flax has no counterpart for) is 0 on the way in and dropped on the way out.

Any mapping keyed like the parameters crosses the same way: a dict of
gradients, or Adam's moments (`moments_to_flax` / `moments_from_flax`, the
shape of ``optax``'s ``mu`` and ``nu`` trees), so a training comparison can
hold every tensor of a step against the JAX package's.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, Mapping

import numpy as np
import torch

_TO_TORCH = {
    "kernel": "weight",
    "scale": "weight",
    "bias": "bias",
    "mean": "running_mean",
    "var": "running_var",
}


def _flatten(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    """Nested Flax variables, or the flat '/'-joined mapping that
    ``checkpoint.save_params_npz`` writes, as a flat '/'-keyed dict."""
    flat = {}
    for key, value in tree.items():
        path = f"{prefix}/{key}" if prefix else str(key)
        if isinstance(value, Mapping):
            flat.update(_flatten(value, path))
        else:
            flat[path] = np.asarray(value)
    return flat


def from_flax_variables(tree: Mapping) -> "OrderedDict[str, torch.Tensor]":
    """Flax variables ({'params', 'batch_stats'} tree or npz mapping) ->
    PyTorch state_dict."""
    state = OrderedDict()
    for path, value in _flatten(tree).items():
        collection, *modules, leaf = path.split("/")
        if collection not in ("params", "batch_stats") or leaf not in _TO_TORCH:
            raise ValueError(f"unexpected Flax variable {path!r}")
        if leaf == "kernel":
            value = value.transpose(3, 2, 0, 1)
        state[".".join(modules + [_TO_TORCH[leaf]])] = torch.tensor(value)
        if leaf == "var":
            state[".".join(modules + ["num_batches_tracked"])] = torch.tensor(0)
    return state


def to_flax_variables(state_dict: Mapping[str, torch.Tensor]) -> Dict[str, dict]:
    """PyTorch state_dict -> nested Flax variables of NumPy arrays."""
    tree: Dict[str, dict] = {"params": {}, "batch_stats": {}}
    for key, tensor in state_dict.items():
        *modules, leaf = key.split(".")
        if leaf == "num_batches_tracked":
            continue
        value = tensor.detach().cpu()
        if value.dtype == torch.bfloat16:  # NumPy has no bfloat16
            value = value.float()
        value = value.numpy()
        if leaf == "weight" and value.ndim == 4:
            collection, flax_leaf = "params", "kernel"
            value = value.transpose(2, 3, 1, 0)
        elif leaf == "weight":
            collection, flax_leaf = "params", "scale"
        elif leaf == "bias":
            collection, flax_leaf = "params", "bias"
        elif leaf == "running_mean":
            collection, flax_leaf = "batch_stats", "mean"
        elif leaf == "running_var":
            collection, flax_leaf = "batch_stats", "var"
        else:
            raise ValueError(f"unexpected state_dict key {key!r}")
        node = tree[collection]
        for name in modules:
            node = node.setdefault(name, {})
        node[flax_leaf] = np.array(value)  # a copy: never a view of live state
    return tree


def moments_to_flax(moments: Mapping[str, torch.Tensor]) -> Dict[str, dict]:
    """Per-parameter tensors keyed by ``state_dict`` names (gradients, Adam's
    ``mu`` or ``nu``) -> a tree shaped like Flax's ``params`` (and like the
    ``mu`` / ``nu`` of ``optax.adam``'s state).  bfloat16 comes out as f32."""
    return to_flax_variables(moments)["params"]


def moments_from_flax(tree: Mapping) -> "OrderedDict[str, torch.Tensor]":
    """A ``params``-shaped tree (``optax``'s ``mu`` / ``nu``, or gradients)
    -> tensors keyed by ``state_dict`` names."""
    return from_flax_variables({"params": tree})
