"""The yardstick's counts against hand counts, and the readings that every
configuration pins: its seeded weights and its convolutions' shapes, so that
a change to the harness that moves them shows.

A configuration's pins are ``pins/<config>.json``, written when the
configuration is added (``json.dumps(readings(<config>))``) and never
rewritten: the running statistics are summed, not hashed, since their last
bits follow the CPU's convolution kernels and thread count."""

import hashlib
import json

import pytest

from benchmark.harness import catalog
from benchmark.harness.weights import draw
from benchmark.reference.model import Network, conv_shapes
from benchmark.tests import small
from benchmark.work import flops, mbconv, peaks

CONFIGS = [c["name"] for c in catalog.load_bench()["configs"]]
PINS = catalog.BENCH_DIR / "tests" / "pins"
PIN_SEED = 7
STATISTICS = ("running_mean", "running_var")


def _config(name):
    entry = next(c for c in catalog.load_bench()["configs"] if c["name"] == name)
    return json.loads((catalog.ROOT / entry["file"]).read_text())


def _digest(weights, leave_out=()):
    """sha256 of every entry (name, dtype, shape, bytes) in order, less the
    entries whose names end with one of ``leave_out``."""
    h = hashlib.sha256()
    for k, v in weights.items():
        if not k.endswith(leave_out):
            h.update(f"{k}|{v.dtype}|{tuple(v.shape)}|".encode())
            h.update(v.contiguous().numpy().tobytes())
    return h.hexdigest()


def _shapes_digest(shapes):
    listed = [[list(w), list(o), g] for w, o, g in shapes]
    return hashlib.sha256(json.dumps(listed).encode()).hexdigest()


def readings(name):
    """What ``pins/<name>.json`` holds: the seeded weights at 96 x 128 on
    the CPU (seed 7), the convolutions' shapes at the configuration's size
    and at 96 x 128, and the forward's operations an image."""
    small.cpu()
    config = _config(name)
    model = small.small_config(config)["model"]
    weights = draw(model, PIN_SEED, "cpu")
    return {"entries": len(weights), "drawn_sha256": _digest(weights, STATISTICS),
            "running_mean_abs_sum": sum(float(v.double().abs().sum()) for k, v in weights.items()
                                        if k.endswith("running_mean")),
            "running_var_sum": sum(float(v.double().sum()) for k, v in weights.items()
                                   if k.endswith("running_var")),
            "convs": len(conv_shapes(config["model"])),
            "conv_shapes_sha256": _shapes_digest(conv_shapes(config["model"])),
            "conv_shapes_sha256_96x128": _shapes_digest(conv_shapes(model)),
            "forward_flops_per_image": flops.forward_flops_per_image(config["model"])}


def _pin(name):
    path = PINS / f"{name}.json"
    assert path.is_file(), f"{name} has no pins: write {path} from readings({name!r})"
    return json.loads(path.read_text())


@pytest.mark.parametrize("name", CONFIGS)
def test_decoder_conv_against_a_hand_count(name):
    """The decoder's 3x3 conv, 256 + 48 -> 256 at the skip's map."""
    rows, cols = _pin(name)["decoder_conv_rows_cols"]
    hand = 2.0 * rows * cols * 256 * (256 + 48) * 9
    assert hand == pytest.approx(_pin(name)["decoder_conv_flops"])
    counted = [flops.conv_flops(*s) for s in conv_shapes(_config(name)["model"])
               if s[0] == (256, 256 + 48, 3, 3)]
    assert counted == [pytest.approx(hand)]


@pytest.mark.parametrize("name", CONFIGS)
def test_forward_counts(name):
    model, pin = _config(name)["model"], _pin(name)
    assert flops.forward_flops_per_image(model) == pin["forward_flops_per_image"]
    assert flops.train_flops_per_image(model) == 3 * flops.forward_flops_per_image(model)
    assert len(conv_shapes(model)) == pin["convs"]


@pytest.mark.parametrize("name", CONFIGS)
def test_seeded_weights_and_shapes_are_pinned(name):
    ours, pin = readings(name), _pin(name)
    for key in ("running_mean_abs_sum", "running_var_sum"):
        assert ours.pop(key) == pytest.approx(pin[key], rel=1e-6), key
    assert ours == {k: pin[k] for k in ours}


def test_a_parameter_the_harness_cannot_draw_is_refused(tmp_path, monkeypatch):
    """A backbone with an ``nn.Linear`` (a squeeze-and-excitation layer, say)
    is refused by name rather than served zeros."""
    from benchmark.reference import model as ref_model

    (tmp_path / "linear_toy.py").write_text(
        "import torch.nn as nn\n"
        "from benchmark.reference.model import ConvBN\n\n\n"
        "def backbone(model):\n"
        "    return nn.ModuleDict({'stem': ConvBN(3, 8, 3, 2), 'se': nn.Linear(8, 8)})\n\n\n"
        "def wiring(model):\n"
        "    return {'fm1_channels': 8, 'fm2_channels': 8, 'skip_channels': 8, 'relu_max': 6.0,\n"
        "            'extra': ((8, 'extra1'), (8, 'extra2'))}\n")
    monkeypatch.setattr(ref_model, "BACKBONES", tmp_path)
    model = {**_config(CONFIGS[0])["model"], "backbone": "linear_toy"}
    assert "backbone.se.weight" in Network(model).state_dict()
    with pytest.raises(ValueError, match=r"'backbone\.se\.weight' \(Linear\.weight"):
        draw(model, PIN_SEED, "cpu")


def test_mbconv_blocks_and_bound():
    blocks = mbconv.blocks()
    assert [c for c, _, _ in blocks] == [24, 32, 32, 64, 64, 64, 96, 96, 160, 160]
    assert blocks[0][1:] == (120, 160) and blocks[-1][1:] == (15, 20)
    ops, nbytes = mbconv.block_work(24, 120, 160, 16)
    assert ops == 2.0 * 16 * 120 * 160 * (24 * 144 * 2 + 9 * 144)
    assert nbytes == 2 * (2 * 16 * 120 * 160 * 24 + 24 * 144 * 2 + 144 * 11 + 24)
    least = mbconv.least_seconds(16)
    assert least["seconds"] >= max(least["operations_s"], least["bytes_s"])
    assert least["seconds"] == pytest.approx(3.594e-5, rel=1e-3)
    assert peaks.BF16_DENSE_FLOPS == 989e12 and peaks.HBM_BYTES_PER_S == 3.35e12
