"""Keras checkpoint import: name-mapped weight transfer into the port's
``state_dict``.

Counterpart of ``ssdseglib_tpu/keras_import.py``.  The reference ships a
trained Keras checkpoint (``models/mobilenetv2-deeplabv3plus-ssdlite-105-
epoch.keras``) whose weights load into the model here.  The importer takes a
``{keras_layer_name: [arrays...]}`` dict -- from a live Keras model
(`weights_by_layer_from_keras_model`), a TF-2.13 ``.keras`` zip
(`load_keras_file`), or any other source -- and produces the port's
``state_dict`` through an explicit per-layer table (`build_layer_maps`)
generated from the naming scheme of the reference builder (reference
models.py:62-111, blocks.py:25-155).  The port's modules carry the Flax
module names, so a table row's ``module_path`` is the JAX package's Flax
path.

Layout transforms (the rules of ``weights.py``):
    Conv2D kernel        (kh, kw, Cin, Cout)  ->  weight (Cout, Cin, kh, kw)
    DepthwiseConv2D      (kh, kw, C, 1)       ->  weight (C, 1, kh, kw)
    SeparableConv2D dw   (kh, kw, Cin, 1)     ->  depthwise.weight (Cin, 1, kh, kw)
    SeparableConv2D pw   (1, 1, Cin, Cout)    ->  pointwise.weight (Cout, Cin, 1, 1)
    BatchNormalization   [gamma, beta, moving_mean, moving_var]
                         -> weight, bias, running_mean, running_var
                            (and num_batches_tracked = 0)

NumPy and PyTorch only: the ``.keras`` reader and writer import ``h5py``
when called, and the live-model helpers are duck-typed (no TensorFlow).
"""

from __future__ import annotations

import dataclasses
import warnings
from collections import OrderedDict
from typing import Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from ssdseglib_torch.config import ModelConfig

# Keras kernel layout -> the port's weight layout
_CONV = (3, 2, 0, 1)  # (kh, kw, I, O) -> (O, I, kh, kw)
_DEPTHWISE = (2, 3, 0, 1)  # (kh, kw, C, 1) -> (C, 1, kh, kw)
_BATCHNORM = ("weight", "bias", "running_mean", "running_var")


@dataclasses.dataclass(frozen=True)
class LayerMap:
    """One module of the port <-> Keras layer(s) correspondence."""

    module_path: Tuple[str, ...]  # path of the module in the state_dict
    kind: str  # 'convbn' | 'conv' | 'conv_bias' | 'depthwisebn' | 'sepconvbn'
    keras_conv: str  # Keras conv-ish layer name
    keras_bn: Optional[str] = None  # Keras batchnorm layer name (if any)


def _mobilenetv2_maps() -> List[LayerMap]:
    maps: List[LayerMap] = []
    # stem (block 0) + 16 blocks (reference models.py:196-210 channel plan)
    for block in range(0, 17):
        for stage in ("expand", "depthwise", "project"):
            base = f"backbone-block{block}-{stage}"
            kind = "depthwisebn" if stage == "depthwise" else "convbn"
            maps.append(LayerMap(("backbone", base), kind, f"{base}-conv",
                                 f"{base}-batchnorm"))
    # extra detection feature blocks (models.py:234-244)
    for block in (17, 18):
        maps.append(LayerMap((f"backbone-block{block}",), "sepconvbn",
                             f"backbone-block{block}-sepconv",
                             f"backbone-block{block}-batchnorm"))
    return maps


def _shufflenetv2_maps(cfg: ModelConfig) -> List[LayerMap]:
    maps: List[LayerMap] = [
        LayerMap(("backbone", "backbone-stage1-conv"), "conv_bias", "backbone-stage1-conv")
    ]
    extra_dw = cfg.shufflenet_extra_depthwise

    def add(kind, name, bn_suffix):
        # the module is named like its conv; its BN carries its own suffix
        maps.append(LayerMap(("backbone", name), kind, name,
                             name.rsplit("-", 1)[0] + "-" + bn_suffix))

    for stage, n_blocks in ((2, 3), (3, 7), (4, 3)):
        p = f"backbone-stage{stage}-downblock-"
        add("depthwisebn", f"{p}branch-left-depthconv1", "batchnorm1")
        add("convbn", f"{p}branch-left-conv2", "batchnorm2")
        if extra_dw:
            add("depthwisebn", f"{p}branch-right-depthconv0", "batchnorm0")
        add("convbn", f"{p}branch-right-conv1", "batchnorm1")
        add("depthwisebn", f"{p}branch-right-depthconv2", "batchnorm2")
        add("convbn", f"{p}branch-right-conv3", "batchnorm3")
        for b in range(1, n_blocks + 1):
            p = f"backbone-stage{stage}-block{b}-"
            if extra_dw:
                add("depthwisebn", f"{p}branch-conv-depthconv0", "batchnorm0")
            add("convbn", f"{p}branch-conv-conv1", "batchnorm1")
            add("depthwisebn", f"{p}branch-conv-depthconv2", "batchnorm2")
            add("convbn", f"{p}branch-conv-conv3", "batchnorm3")
    for block in (1, 2):
        maps.append(LayerMap((f"backbone-stage5-block{block}",), "sepconvbn",
                             f"backbone-stage5-block{block}-sepconv",
                             f"backbone-stage5-block{block}-batchnorm"))
    return maps


def _head_maps(cfg: ModelConfig) -> List[LayerMap]:
    maps: List[LayerMap] = []
    # DeepLabV3+ encoder (reference blocks.py:25-72 naming)
    maps.append(LayerMap(("mask-encoder", "aspp-pointwise"), "convbn",
                         "mask-encoder-aspp-pointwise-conv",
                         "mask-encoder-aspp-pointwise-batchnorm"))
    for k in (1, 2, 3):
        maps.append(LayerMap(("mask-encoder", f"aspp-atrous{k}"), "sepconvbn",
                             f"mask-encoder-aspp-atrous{k}-sepconv",
                             f"mask-encoder-aspp-atrous{k}-batchnorm"))
    maps.append(LayerMap(("mask-encoder", "pooling"), "convbn",
                         "mask-encoder-pooling-conv", "mask-encoder-pooling-batchnorm"))
    maps.append(LayerMap(("mask-encoder", "output"), "convbn",
                         "mask-encoder-output-conv", "mask-encoder-output-batchnorm"))
    # decoder (blocks.py:100-129 naming)
    maps.append(LayerMap(("mask-decoder", "backbone-reduce"), "convbn",
                         "mask-decoder-backbone-conv", "mask-decoder-backbone-batchnorm"))
    maps.append(LayerMap(("mask-decoder", "conv"), "convbn",
                         "mask-decoder-conv", "mask-decoder-conv-batchnorm"))
    maps.append(LayerMap(("mask-decoder", "sepconv"), "sepconvbn",
                         "mask-decoder-sepconv", "mask-decoder-sepconv-batchnorm"))
    maps.append(LayerMap(("mask-decoder", "output-conv"), "conv", "mask-decoder-output-conv"))
    # SSDLite heads (models.py:250-268 naming)
    for branch in ("labels", "boxes"):
        for k in (1, 2, 3, 4):
            maps.append(LayerMap(("heads", f"{branch}{k}", "sepconv"), "sepconvbn",
                                 f"{branch}{k}-sepconv", f"{branch}{k}-batchnorm"))
    return maps


def build_layer_maps(cfg: ModelConfig) -> List[LayerMap]:
    """The table of every weight-carrying layer of the model ``cfg`` builds."""
    if cfg.backbone == "mobilenetv2":
        maps = _mobilenetv2_maps()
    elif cfg.backbone == "shufflenetv2":
        maps = _shufflenetv2_maps(cfg)
    else:
        raise ValueError(cfg.backbone)
    return maps + _head_maps(cfg)


def _tensor(array: np.ndarray, axes=None) -> torch.Tensor:
    array = np.asarray(array)
    if axes is not None:
        array = array.transpose(axes)
    return torch.tensor(array)  # a copy: never a view of the caller's arrays


def import_keras_weights(
    weights_by_layer: Mapping[str, List[np.ndarray]], cfg: ModelConfig
) -> "OrderedDict[str, torch.Tensor]":
    """The port's ``state_dict`` (CPU tensors) from Keras layer weights.

    Args:
        weights_by_layer: {keras layer name: [weight arrays in Keras order]}
        cfg: the model configuration (drives the mapping table)
    A layer the table names and the checkpoint lacks raises KeyError; a
    checkpoint layer no row consumes warns (the checkpoint was produced by
    another configuration, e.g. another ``shufflenet_extra_depthwise``).
    """
    state: "OrderedDict[str, torch.Tensor]" = OrderedDict()
    used = set()

    def take(name: str) -> List[np.ndarray]:
        if name not in weights_by_layer:
            raise KeyError(f"keras layer {name!r} not found in checkpoint")
        used.add(name)
        return [np.asarray(w) for w in weights_by_layer[name]]

    def put(path: Tuple[str, ...], leaf: str, value: torch.Tensor) -> None:
        state[".".join(path + (leaf,))] = value

    def put_bn(path: Tuple[str, ...], keras_bn: str) -> None:
        for leaf, array in zip(_BATCHNORM, take(keras_bn)):
            put(path + ("batchnorm",), leaf, _tensor(array))
        put(path + ("batchnorm",), "num_batches_tracked", torch.tensor(0))

    for m in build_layer_maps(cfg):
        path = m.module_path
        if m.kind == "convbn":
            (kernel,) = take(m.keras_conv)
            put(path + ("conv",), "weight", _tensor(kernel, _CONV))
            put_bn(path, m.keras_bn)
        elif m.kind == "conv":
            (kernel,) = take(m.keras_conv)
            put(path, "weight", _tensor(kernel, _CONV))
        elif m.kind == "conv_bias":
            kernel, bias = take(m.keras_conv)
            put(path, "weight", _tensor(kernel, _CONV))
            put(path, "bias", _tensor(bias))
        elif m.kind == "depthwisebn":
            (kernel,) = take(m.keras_conv)
            put(path + ("conv",), "weight", _tensor(kernel, _DEPTHWISE))
            put_bn(path, m.keras_bn)
        elif m.kind == "sepconvbn":
            dw, pw = take(m.keras_conv)
            put(path + ("depthwise",), "weight", _tensor(dw, _DEPTHWISE))
            put(path + ("pointwise",), "weight", _tensor(pw, _CONV))
            put_bn(path, m.keras_bn)
        else:
            raise ValueError(m.kind)

    unused = set(weights_by_layer) - used
    if unused:
        warnings.warn(
            f"{len(unused)} checkpoint layer(s) not consumed by the "
            f"{cfg.backbone} mapping (config mismatch?): "
            f"{sorted(unused)[:8]}{'...' if len(unused) > 8 else ''}"
        )
    return state


def _array(tensor: torch.Tensor, axes=None) -> np.ndarray:
    tensor = tensor.detach().cpu()
    if tensor.dtype == torch.bfloat16:  # NumPy has no bfloat16
        tensor = tensor.float()
    array = tensor.numpy()
    # the inverse of the import's transpose
    return np.ascontiguousarray(array.transpose(np.argsort(axes)) if axes else array)


def export_keras_weights(
    state_dict: Mapping[str, torch.Tensor], cfg: ModelConfig
) -> Dict[str, List[np.ndarray]]:
    """Inverse of `import_keras_weights`: the port's ``state_dict`` ->
    ``{keras layer name: [weights in Keras order]}`` (NumPy; bfloat16 comes
    out as float32), ready for `apply_to_keras_model` or `save_keras_file`."""
    out: Dict[str, List[np.ndarray]] = {}

    def get(path: Tuple[str, ...], leaf: str, axes=None) -> np.ndarray:
        return _array(state_dict[".".join(path + (leaf,))], axes)

    def bn(path: Tuple[str, ...], keras_bn: str) -> None:
        out[keras_bn] = [get(path + ("batchnorm",), leaf) for leaf in _BATCHNORM]

    for m in build_layer_maps(cfg):
        path = m.module_path
        if m.kind == "convbn":
            out[m.keras_conv] = [get(path + ("conv",), "weight", _CONV)]
            bn(path, m.keras_bn)
        elif m.kind == "conv":
            out[m.keras_conv] = [get(path, "weight", _CONV)]
        elif m.kind == "conv_bias":
            out[m.keras_conv] = [get(path, "weight", _CONV), get(path, "bias")]
        elif m.kind == "depthwisebn":
            out[m.keras_conv] = [get(path + ("conv",), "weight", _DEPTHWISE)]
            bn(path, m.keras_bn)
        elif m.kind == "sepconvbn":
            out[m.keras_conv] = [get(path + ("depthwise",), "weight", _DEPTHWISE),
                                 get(path + ("pointwise",), "weight", _CONV)]
            bn(path, m.keras_bn)
        else:
            raise ValueError(m.kind)
    return out


def _h5py():
    try:
        import h5py
    except ImportError as e:
        raise ImportError(
            "reading or writing a .keras file needs h5py, which is not installed; "
            "import_keras_weights / export_keras_weights take the "
            "{layer name: [arrays]} dict without it"
        ) from e
    return h5py


def load_keras_file(path: str) -> Dict[str, List[np.ndarray]]:
    """Read a TF-2.13 ``.keras`` zip (the reference checkpoint format) into a
    {layer name: [arrays]} dict.

    Keras's saving_lib addresses each layer's weight group by the
    snake-cased class name plus an occurrence index, not by ``layer.name``,
    and records the true layer name as the ``name`` attribute of the
    ``vars`` group (``_layer_checkpoint_dependencies/<class_snake>/vars/<i>``
    in 2.13, ``layers/...`` in Keras 3).  The layer key is that attribute
    where present, else the path component above ``vars`` (files from
    simpler writers keyed by layer name directly).  Needs ``h5py``.
    """
    import io
    import zipfile

    h5py = _h5py()
    with zipfile.ZipFile(path) as zf:
        with zf.open("model.weights.h5") as fh:
            data = fh.read()

    out: Dict[str, list] = {}

    def visit(name, obj):
        if not isinstance(obj, h5py.Dataset):
            return
        parts = name.split("/")
        if "vars" not in parts[:-1]:
            return
        i = len(parts) - 2 - parts[:-1][::-1].index("vars")
        if i == 0:
            return  # top-level model vars group, not a layer
        vars_group = h5["/".join(parts[: i + 1])]
        layer = vars_group.attrs.get("name", parts[i - 1])
        if isinstance(layer, bytes):
            layer = layer.decode()
        try:
            index = int(parts[i + 1])
        except ValueError:
            # variable datasets named non-numerically: keep file order
            index = len(out.get(layer, ()))
        out.setdefault(layer, []).append((index, obj[()]))

    with h5py.File(io.BytesIO(data), "r") as h5:
        h5.visititems(visit)
    return {layer: [arr for _, arr in sorted(items, key=lambda item: item[0])]
            for layer, items in out.items()}


def save_keras_file(
    path: str,
    weights_by_layer: Mapping[str, List[np.ndarray]],
    extra_files: Optional[Dict[str, str]] = None,
) -> None:
    """Write a TF-2.13-layout ``.keras`` zip (what ``model.save`` produces,
    reference notebook 03 cell 17): metadata.json, config.json and
    model.weights.h5 in that order, each layer's weights under
    ``_layer_checkpoint_dependencies/<class_snake[_k]>/vars/<i>`` with the
    layer name as the ``vars`` group's ``name`` attribute (the class is
    inferred from the layer-name suffix).  ``extra_files`` maps further zip
    member names to string contents.  Round-trips through `load_keras_file`.
    Needs ``h5py``."""
    import io
    import json
    import zipfile

    h5py = _h5py()

    def class_snake(layer: str) -> str:
        if layer.endswith("-batchnorm"):
            return "batch_normalization"
        if layer.endswith("-sepconv"):
            return "separable_conv2d"
        if layer.endswith("-depthwise-conv") or layer.endswith("-depthwise"):
            return "depthwise_conv2d"
        if layer.endswith("-conv"):
            return "conv2d"
        return "layer"

    buf = io.BytesIO()
    used: Dict[str, int] = {}
    with h5py.File(buf, "w") as h5:
        root = h5.create_group("_layer_checkpoint_dependencies")
        for layer, arrays in weights_by_layer.items():
            base = class_snake(layer)
            k = used.get(base)
            used[base] = 0 if k is None else k + 1
            group = base if k is None else f"{base}_{used[base]}"
            g = root.create_group(group).create_group("vars")
            g.attrs["name"] = layer
            for i, arr in enumerate(arrays):
                g.create_dataset(str(i), data=np.asarray(arr))
    with zipfile.ZipFile(path, "w") as zf:
        zf.writestr("metadata.json", json.dumps({"keras_version": "2.13.1"}))
        zf.writestr("config.json", json.dumps({"class_name": "Functional"}))
        zf.writestr("model.weights.h5", buf.getvalue())
        for name, content in (extra_files or {}).items():
            zf.writestr(name, content)


def weights_by_layer_from_keras_model(model) -> Dict[str, List[np.ndarray]]:
    """{layer name: weights} from a live Keras model (anything with
    ``layers`` whose items have ``name`` and ``get_weights()``)."""
    return {
        layer.name: [np.asarray(w) for w in layer.get_weights()]
        for layer in model.layers
        if layer.get_weights()
    }


def apply_to_keras_model(model, weights_by_layer: Mapping[str, List[np.ndarray]]):
    """Load a {layer name: [weights]} dict into a live Keras model (anything
    with ``layers`` whose items have ``name``, ``get_weights()`` and
    ``set_weights()``)."""
    for layer in model.layers:
        if layer.get_weights():
            if layer.name not in weights_by_layer:
                raise KeyError(f"no exported weights for layer {layer.name!r}")
            layer.set_weights(weights_by_layer[layer.name])
    return model


def validate_against_template(
    state_dict: Mapping[str, torch.Tensor], template: Mapping[str, torch.Tensor]
) -> None:
    """Check an imported ``state_dict`` against the model's own (its keys
    and every tensor's shape), raising ValueError on any difference."""
    missing = set(template) - set(state_dict)
    extra = set(state_dict) - set(template)
    if missing or extra:
        raise ValueError(
            f"import mismatch: missing={sorted(missing)[:5]} extra={sorted(extra)[:5]}"
        )
    for key, tensor in template.items():
        if tuple(state_dict[key].shape) != tuple(tensor.shape):
            raise ValueError(
                f"{key}: shape {tuple(state_dict[key].shape)} != expected "
                f"{tuple(tensor.shape)}"
            )
