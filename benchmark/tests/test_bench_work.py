"""The yardstick's counts against hand counts."""

import json

import pytest

from benchmark.harness import catalog
from benchmark.reference.model import conv_shapes
from benchmark.work import flops, mbconv, peaks

MNV2 = json.loads((catalog.BENCH_DIR / "configs" / "mobilenetv2-dlv3p-ssdlite-480x640.json").read_text())
SHUF = json.loads((catalog.BENCH_DIR / "configs" / "shufflenetv2-1.5x-dlv3p-ssdlite-480x640.json").read_text())


@pytest.mark.parametrize("config,rows,cols,skip,expected", [
    (MNV2, 120, 160, 48, 26.8959744e9),   # os4 skip, 256 + 48 -> 256
    (SHUF, 60, 80, 48, 6.7239936e9),      # os8 skip
])
def test_decoder_conv_against_a_hand_count(config, rows, cols, skip, expected):
    hand = 2.0 * rows * cols * 256 * (256 + skip) * 9
    assert hand == pytest.approx(expected)
    counted = [flops.conv_flops(*s) for s in conv_shapes(config["model"])
               if s[0] == (256, 256 + skip, 3, 3)]
    assert counted == [pytest.approx(hand)]


def test_forward_counts():
    assert flops.forward_flops_per_image(MNV2["model"]) == pytest.approx(35.91e9, rel=1e-3)
    assert flops.forward_flops_per_image(SHUF["model"]) == pytest.approx(12.68e9, rel=1e-3)
    assert flops.train_flops_per_image(MNV2["model"]) == 3 * flops.forward_flops_per_image(MNV2["model"])
    assert len(conv_shapes(MNV2["model"])) == 85 and len(conv_shapes(SHUF["model"])) == 105


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
