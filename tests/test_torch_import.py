"""The PyTorch port imports without JAX, and its framework-free copies
(config dataclasses, anchors) equal the JAX package's exactly."""

import dataclasses
import os
import subprocess
import sys

import numpy as np

from ssdseglib_tpu import boxes as tpu_boxes
from ssdseglib_tpu import config as tpu_config

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SLICE_MODULES = (
    "ssdseglib_torch",
    "ssdseglib_torch.config",
    "ssdseglib_torch.boxes",
    "ssdseglib_torch.weights",
    "ssdseglib_torch.layers",
    "ssdseglib_torch.losses",
    "ssdseglib_torch.metrics",
    "ssdseglib_torch.train",
    "ssdseglib_torch.data.synthetic",
    "ssdseglib_torch.models.blocks",
    "ssdseglib_torch.models.mobilenetv2",
    "ssdseglib_torch.models.heads",
    "ssdseglib_torch.models.builder",
    "ssdseglib_torch.models.fused_inference",
    "ssdseglib_torch.ops.fused_mbconv",
    "ssdseglib_torch.ops.depthwise_backward",
    "ssdseglib_torch.ops.fused_chain_backward",
    "ssdseglib_torch.ops._cuda_build",
    "ssdseglib_torch.ops.encoding",
    "ssdseglib_torch.ops.nms",
    "ssdseglib_torch.utils.serving",
)


def test_port_imports_no_jax_flax_tensorflow_triton():
    code = (
        "import importlib, sys\n"
        f"for name in {SLICE_MODULES!r}:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'optax',\n"
        "                                    'tensorflow', 'triton', 'ssdseglib_tpu'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
        timeout=120,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_config_dataclasses_equal_jax_package():
    from ssdseglib_torch import config as port_config

    ours = port_config.reference_warehouse_config()
    theirs = tpu_config.reference_warehouse_config()
    for a, b in zip(ours, theirs):
        assert type(a).__name__ == type(b).__name__
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
    for name in ("AnchorsConfig", "EncodingConfig", "NmsConfig", "ModelConfig",
                 "TrainConfig"):
        ours_fields = [
            (f.name, f.default) for f in dataclasses.fields(getattr(port_config, name))
        ]
        theirs_fields = [
            (f.name, f.default) for f in dataclasses.fields(getattr(tpu_config, name))
        ]
        assert ours_fields == theirs_fields, name


def test_warehouse_anchors_equal_jax_package():
    from ssdseglib_torch import boxes as port_boxes
    from ssdseglib_torch import config as port_config

    a_cfg, e_cfg = port_config.reference_warehouse_config()[:2]
    ours = port_boxes.Anchors.from_config(a_cfg, e_cfg.image_shape)
    a_cfg, e_cfg = tpu_config.reference_warehouse_config()[:2]
    theirs = tpu_boxes.Anchors.from_config(a_cfg, e_cfg.image_shape)
    assert ours.total_boxes == theirs.total_boxes == 9600
    for field in ("corners", "centroids", "area"):
        a, b = getattr(ours, field), getattr(theirs, field)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b, err_msg=field)


def test_every_module_of_the_port_is_listed():
    """A module added to the port is added to SLICE_MODULES, so the import
    check above covers it."""
    package = os.path.join(ROOT, "ssdseglib_torch")
    found = set()
    for directory, _, files in os.walk(package):
        for name in files:
            if not name.endswith(".py"):
                continue
            rel = os.path.relpath(os.path.join(directory, name), ROOT)[:-3]
            module = rel.replace(os.sep, ".")
            if module.endswith(".__init__"):
                module = module[: -len(".__init__")]
            found.add(module)
    subpackages = {"ssdseglib_torch.models", "ssdseglib_torch.ops",
                   "ssdseglib_torch.utils", "ssdseglib_torch.data"}
    assert found - subpackages == set(SLICE_MODULES)


def test_kernel_sources_and_build_name_the_library():
    """The three CUDA sources and the shared header exist where the builder
    looks for them, and the missing-compiler message names the library."""
    import pytest

    from ssdseglib_torch.ops import _cuda_build

    names = sorted(p.name for p in _cuda_build.SOURCES)
    assert names == ["depthwise_backward.cu", "fused_chain_backward.cu", "fused_mbconv.cu"]
    for path in _cuda_build.SOURCES + _cuda_build.HEADERS:
        assert path.is_file(), path
    if _cuda_build.shutil.which("nvcc") is None and not os.path.exists(
            "/usr/local/cuda/bin/nvcc") and not os.environ.get("CUDA_HOME"):
        with pytest.raises(RuntimeError, match="kernel library"):
            _cuda_build.find_nvcc()
