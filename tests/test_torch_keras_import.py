"""Keras weight import of the port (`ssdseglib_torch.keras_import`) against
the JAX package's importer on the same Keras-layout weights: the JAX
package's `export_keras_weights` of Flax variables, imported by the port,
equals the Flax bridge (`weights.from_flax_variables`) exactly, for
MobileNetV2 and both ShuffleNetV2 options; the port's export equals the
JAX export array for array; `.keras` files cross between the two."""

import dataclasses
import sys
import warnings

import jax
import numpy as np
import pytest
import torch

from ssdseglib_tpu import keras_import as jax_keras
from ssdseglib_torch import keras_import
from ssdseglib_torch.config import ModelConfig as PortModelConfig
from ssdseglib_torch.models.builder import SsdSegModel
from ssdseglib_torch.weights import from_flax_variables, to_flax_variables
from tests.torch_parity import (  # noqa: F401
    SMALL_CFG,
    images,
    randomize_batchnorm,
    two_torch_threads,
)

CONFIGS = {
    "mobilenetv2": SMALL_CFG,
    "shufflenetv2-plain": dataclasses.replace(
        SMALL_CFG, backbone="shufflenetv2", shufflenet_size="0.5x",
        shufflenet_extra_depthwise=False, shufflenet_residuals=False),
    "shufflenetv2-extra-dw+residual": dataclasses.replace(
        SMALL_CFG, backbone="shufflenetv2", shufflenet_size="0.5x",
        shufflenet_extra_depthwise=True, shufflenet_residuals=True),
}


def _port_cfg(cfg):
    return PortModelConfig(**vars(cfg))


@pytest.fixture(scope="module", params=list(CONFIGS))
def side(request):
    """(JAX config, Flax variables of random values, their Keras layers as
    the JAX package exports them).  The variables are the port's init
    (Flax's distributions from a torch.Generator, quicker than compiling the
    Flax init) with randomised BatchNorm, through the Flax bridge."""
    cfg = CONFIGS[request.param]
    model = SsdSegModel(_port_cfg(cfg), torch.Generator().manual_seed(3))
    variables = randomize_batchnorm(to_flax_variables(model.state_dict()), seed=3)
    return cfg, variables, jax_keras.export_keras_weights(variables, cfg)


def test_layer_maps_equal_the_jax_tables(side):
    cfg = side[0]
    ours = [(m.module_path, m.kind, m.keras_conv, m.keras_bn)
            for m in keras_import.build_layer_maps(_port_cfg(cfg))]
    theirs = [(m.flax_path, m.kind, m.keras_conv, m.keras_bn)
              for m in jax_keras.build_layer_maps(cfg)]
    assert ours == theirs


def test_import_equals_the_flax_bridge(side):
    cfg, variables, keras = side
    state = keras_import.import_keras_weights(keras, _port_cfg(cfg))
    expected = from_flax_variables(variables)
    assert set(state) == set(expected)
    for key, tensor in expected.items():
        assert state[key].dtype == tensor.dtype, key
        assert torch.equal(state[key], tensor), key
    keras_import.validate_against_template(
        state, SsdSegModel(_port_cfg(cfg), torch.Generator().manual_seed(0)).state_dict())


def test_export_equals_the_jax_export(side):
    cfg, variables, keras = side
    ours = keras_import.export_keras_weights(from_flax_variables(variables), _port_cfg(cfg))
    assert list(ours) == list(keras)
    for layer, arrays in keras.items():
        assert len(ours[layer]) == len(arrays), layer
        for a, b in zip(ours[layer], arrays):
            b = np.asarray(b)
            assert a.dtype == b.dtype and a.shape == b.shape, layer
            np.testing.assert_array_equal(a, b, err_msg=layer)


def test_keras_files_cross_between_the_packages(tmp_path):
    cfg = CONFIGS["mobilenetv2"]
    model = SsdSegModel(_port_cfg(cfg), torch.Generator().manual_seed(4))
    keras = keras_import.export_keras_weights(model.state_dict(), _port_cfg(cfg))
    jax_file, port_file = str(tmp_path / "jax.keras"), str(tmp_path / "port.keras")
    jax_keras.save_keras_file(jax_file, keras)
    keras_import.save_keras_file(port_file, keras)
    for read in (keras_import.load_keras_file(jax_file), jax_keras.load_keras_file(port_file),
                 keras_import.load_keras_file(port_file)):
        assert set(read) == set(keras)
        for layer, arrays in keras.items():
            assert len(read[layer]) == len(arrays)
            for a, b in zip(read[layer], arrays):
                np.testing.assert_array_equal(a, b)
    state = keras_import.import_keras_weights(keras_import.load_keras_file(jax_file),
                                              _port_cfg(cfg))
    for key, tensor in model.state_dict().items():
        assert torch.equal(state[key], tensor), key


def test_unconsumed_layers_warn_and_missing_layers_raise(side):
    cfg, _, keras = side
    with pytest.warns(UserWarning, match="1 checkpoint layer"):
        keras_import.import_keras_weights({**keras, "stray-conv": [np.zeros(3)]},
                                          _port_cfg(cfg))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        keras_import.import_keras_weights(keras, _port_cfg(cfg))
    missing = dict(keras)
    del missing["labels1-sepconv"]
    with pytest.raises(KeyError, match="labels1-sepconv"):
        keras_import.import_keras_weights(missing, _port_cfg(cfg))


def test_template_errors():
    cfg = _port_cfg(CONFIGS["mobilenetv2"])
    template = SsdSegModel(cfg, torch.Generator().manual_seed(0)).state_dict()
    state = dict(template)
    keras_import.validate_against_template(state, template)
    key = "backbone.backbone-block1-expand.conv.weight"
    with pytest.raises(ValueError, match="missing=.*block1-expand"):
        keras_import.validate_against_template(
            {k: v for k, v in state.items() if k != key}, template)
    with pytest.raises(ValueError, match="extra=.*stray"):
        keras_import.validate_against_template({**state, "stray.weight": torch.zeros(1)},
                                               template)
    with pytest.raises(ValueError, match="shape"):
        keras_import.validate_against_template({**state, key: state[key][:1]}, template)


def test_keras_files_need_h5py_and_the_dict_api_does_not(monkeypatch, tmp_path):
    """The card's machine has no h5py: the file reader and writer name it;
    import and export of the layer dict work without it."""
    monkeypatch.setitem(sys.modules, "h5py", None)
    with pytest.raises(ImportError, match="h5py"):
        keras_import.load_keras_file(str(tmp_path / "any.keras"))
    with pytest.raises(ImportError, match="h5py"):
        keras_import.save_keras_file(str(tmp_path / "any.keras"), {})
    cfg = _port_cfg(CONFIGS["mobilenetv2"])
    state = SsdSegModel(cfg, torch.Generator().manual_seed(0)).state_dict()
    back = keras_import.import_keras_weights(keras_import.export_keras_weights(state, cfg), cfg)
    assert all(torch.equal(back[k], v) for k, v in state.items())


def test_live_keras_model_helpers_are_duck_typed():
    class Layer:
        def __init__(self, name, weights):
            self.name, self.weights = name, weights

        def get_weights(self):
            return self.weights

        def set_weights(self, weights):
            self.weights = list(weights)

    class Model:
        def __init__(self, layers):
            self.layers = layers

    source = Model([Layer("a-conv", [np.ones((1, 1, 2, 3))]), Layer("input", [])])
    by_layer = keras_import.weights_by_layer_from_keras_model(source)
    assert list(by_layer) == ["a-conv"]
    target = Model([Layer("a-conv", [np.zeros((1, 1, 2, 3))])])
    keras_import.apply_to_keras_model(target, by_layer)
    np.testing.assert_array_equal(target.layers[0].weights[0], 1.0)
    with pytest.raises(KeyError, match="b-conv"):
        keras_import.apply_to_keras_model(Model([Layer("b-conv", [np.zeros(1)])]), by_layer)


def test_imported_model_forward_matches_jax_apply():
    """MobileNetV2 at 96x128 with weights imported from the Keras layers of
    the JAX export: eval-mode outputs against the JAX `apply` on the Flax
    variables, f32, 1e-4 (as `test_torch_model.py`)."""
    from ssdseglib_tpu.models.builder import SsdSegModel as JaxSsdSegModel

    cfg = CONFIGS["mobilenetv2"]
    port = SsdSegModel(_port_cfg(cfg), torch.Generator().manual_seed(6))
    variables = randomize_batchnorm(to_flax_variables(port.state_dict()), seed=6)
    keras = jax_keras.export_keras_weights(variables, cfg)
    port.load_state_dict(keras_import.import_keras_weights(keras, _port_cfg(cfg)))
    module = JaxSsdSegModel(cfg=cfg)
    x = images(1, (1, 96, 128, 3))
    expected = jax.jit(lambda v, x: module.apply(v, x, train=False))(variables, x)
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    assert float(np.asarray(expected["output-mask"]).std()) > 0.01  # not degenerate
    for key in ("output-mask", "output-labels", "output-boxes"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(expected[key]), rtol=1e-4,
                                   atol=1e-4, err_msg=key)
